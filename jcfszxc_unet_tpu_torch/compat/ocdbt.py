"""A read-only OCDBT key-value store: the on-disk format in which
tensorstore (under Orbax, the JAX package's ``save_orbax``) keeps a
checkpoint's zarr arrays.  No tensorstore is needed.

An OCDBT directory holds a manifest (``manifest.ocdbt``) and data files
(``d/<hash>``, also under ``ocdbt.process_<i>/`` when Orbax merged the
per-process trees into the root one).  Manifests and b-tree nodes are
each framed as

    magic (4 bytes, big-endian: 0x0cdb3a2a manifest, 0x0cdb20de node)
    length (8 bytes, little-endian: the framed size)
    version (varint, 0), compression (varint: 0 none, 1 zstd)
    body (zstd-compressed when compression is 1)
    crc32c of everything before it (4 bytes, little-endian)

and every check (magic, length, crc32c, version) is made.  A node lies at
an (offset, length) inside a data file; a value is stored inline in its
leaf node or at an (offset, length) in a data file.  Arrays of numbers
are stored column by column (all first fields, then all second fields).

* Manifest body: config (uuid[16], manifest kind varint (0 = single file;
  the numbered kind is refused), max inline value bytes, max decoded node
  bytes, version tree arity log2 (u8), compression varint (+ zstd level,
  int32 LE, if 1)); a data file table; the versions: count, generation,
  root height (u8), root (file id, offset, length), statistics (keys,
  tree bytes, indirect value bytes), commit time (u64 LE); then the
  references of the older version tree nodes, which are not needed.  The
  newest version, the last one, gives the root.
* Data file table: count; path prefix lengths shared with the previous
  path (all but the first), suffix lengths, base path lengths; the
  suffixes.  A path's first ``base path length`` bytes are its base path,
  the rest its relative path; the base path of the data file that holds
  the node itself (the transitive base path) goes in front of both, and
  the result is relative to the OCDBT root.  (Orbax's merged root refers
  to ``ocdbt.process_<i>/`` this way.)
* B-tree node body: height (u8), a data file table, the entry count, the
  keys (prefix lengths shared with the previous key, all but the first;
  suffix lengths; in interior nodes the length of each subtree's common
  key prefix; the suffixes).  A leaf then holds the value lengths, the
  value kinds (0 inline, 1 indirect), the indirect values' file ids and
  offsets, and the inline values' bytes.  An interior node holds the
  children's (file id, offset, length) and statistics.  A child's keys
  omit the prefix its parent's entry gives (the parent's own prefix plus
  the entry key's first ``common`` bytes).

Each data file is read once, with one ``read``.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np

from jcfszxc_unet_tpu_torch.compat import zstd
from jcfszxc_unet_tpu_torch.compat.host_build import load_host_library

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_NAME = "manifest.ocdbt"
_EMPTY = (1 << 64) - 1  # root offset and length of an empty tree


def crc32c(buf) -> int:
    """CRC-32C (Castagnoli) of ``buf``, through the port's host library."""
    arr = np.frombuffer(buf, dtype=np.uint8)
    return int(load_host_library().crc32c(arr.ctypes.data, arr.size))


class OcdbtError(ValueError):
    """A malformed or unsupported OCDBT file."""


class _Cursor:
    def __init__(self, buf, what: str):
        self.b = memoryview(buf).cast("B")
        self.pos = 0
        self.what = what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.b):
            raise OcdbtError(f"{self.what}: ends at byte {len(self.b)} "
                             f"inside a field at byte {self.pos}")

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.b[self.pos - 1]

    def fixed(self, n: int) -> int:
        self._need(n)
        v = int.from_bytes(self.b[self.pos:self.pos + n], "little")
        self.pos += n
        return v

    def take(self, n: int) -> memoryview:
        self._need(n)
        self.pos += n
        return self.b[self.pos - n:self.pos]

    def varint(self) -> int:
        v = shift = 0
        while True:
            byte = self.u8()
            v |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return v
            shift += 7
            if shift >= 64:
                raise OcdbtError(f"{self.what}: varint longer than 64 bits "
                                 f"at byte {self.pos}")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.b):
            raise OcdbtError(f"{self.what}: {len(self.b) - self.pos} bytes "
                             f"left over after the last field")


def _unframe(buf, magic: int, what: str) -> memoryview:
    """The body of a framed manifest or node, after every check."""
    buf = memoryview(buf).cast("B")
    if len(buf) < 4 + 8 + 2 + 4:
        raise OcdbtError(f"{what}: {len(buf)} bytes is too short")
    got = int.from_bytes(buf[:4], "big")
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(buf[4:12], "little")
    if length != len(buf):
        raise OcdbtError(f"{what}: header says {length} bytes, the file "
                         f"holds {len(buf)}")
    want = int.from_bytes(buf[-4:], "little")
    if crc32c(buf[:-4]) != want:
        raise OcdbtError(f"{what}: crc32c mismatch")
    c = _Cursor(buf[12:-4], what)
    version = c.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} (only 0 is read)")
    method = c.varint()
    rest = c.b[c.pos:]
    if method == 0:
        return rest
    if method == 1:
        return memoryview(zstd.decompress(rest))
    raise OcdbtError(f"{what}: unknown compression method {method}")


class DataFile(NamedTuple):
    """A data file's base path and its path relative to that base."""

    base: str
    relative: str

    @property
    def path(self) -> str:
        return self.base + self.relative


def _data_file_table(c: _Cursor, transitive_base: str) -> List[DataFile]:
    n = c.varint()
    if n == 0:
        return []
    prefix = [0] + c.varints(n - 1)
    suffix = c.varints(n)
    base = c.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{c.what}: data file {i} shares {prefix[i]} "
                             f"bytes of a {len(prev)}-byte path")
        path = prev[:prefix[i]] + bytes(c.take(suffix[i]))
        if base[i] > len(path):
            raise OcdbtError(f"{c.what}: data file {i}'s base path is longer "
                             f"than its path")
        files.append(DataFile(transitive_base + path[:base[i]].decode(),
                              path[base[i]:].decode()))
        prev = path
    return files


def _keys(c: _Cursor, n: int, common: bool):
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    commons = c.varints(n) if common else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{c.what}: key {i} shares {prefix[i]} bytes "
                             f"of a {len(prev)}-byte key")
        prev = prev[:prefix[i]] + bytes(c.take(suffix[i]))
        keys.append(prev)
    return keys, commons


def _file_id(c: _Cursor, files: List[DataFile], i: int) -> DataFile:
    if i >= len(files):
        raise OcdbtError(f"{c.what}: data file id {i} of a table of "
                         f"{len(files)}")
    return files[i]


# A value: its bytes, held inline in a leaf, or where it lies in a data file.
Value = Union[memoryview, Tuple[DataFile, int, int]]


class OcdbtStore:
    """The newest version of the OCDBT tree under ``root`` (the directory
    holding ``manifest.ocdbt``): :meth:`list` its keys, :meth:`read` a
    value.  Keys are ``str`` (the stored bytes decoded as UTF-8)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._files: Dict[str, bytes] = {}
        self._files_lock = threading.Lock()  # readers may share the store
        self._index: Dict[bytes, Value] = {}
        path = os.path.join(self.root, MANIFEST_NAME)
        with open(path, "rb") as f:
            raw = f.read()
        body = _unframe(raw, MANIFEST_MAGIC, path)
        height, ref = self._parse_manifest(_Cursor(body, path))
        if ref is not None:
            self._walk(ref, height, b"")

    # -- reading -------------------------------------------------------
    def list(self) -> List[str]:
        """Every key, in byte order."""
        return [k.decode() for k in sorted(self._index)]

    def get(self, key: str) -> Optional[memoryview]:
        """The value of ``key``, or None when the tree has no such key."""
        ref = self._index.get(key.encode())
        if ref is None:
            return None
        if isinstance(ref, memoryview):
            return ref
        data_file, offset, length = ref
        data = self._file(data_file)
        if offset + length > len(data):
            raise OcdbtError(f"{data_file.path}: value of {key!r} at "
                             f"[{offset}, {offset + length}) lies past the "
                             f"file's {len(data)} bytes")
        return memoryview(data)[offset:offset + length]

    def read(self, key: str) -> memoryview:
        value = self.get(key)
        if value is None:
            raise KeyError(key)
        return value

    # -- parsing -------------------------------------------------------
    def _file(self, data_file: DataFile) -> bytes:
        rel = os.path.normpath(data_file.path)
        if os.path.isabs(rel) or rel == ".." or rel.startswith(".." + os.sep):
            raise OcdbtError(f"data file path {data_file.path!r} leaves the "
                             f"checkpoint directory")
        with self._files_lock:
            data = self._files.get(rel)
            if data is None:
                with open(os.path.join(self.root, rel), "rb") as f:
                    data = f.read()
                self._files[rel] = data
        return data

    def _parse_manifest(self, c: _Cursor):
        c.take(16)  # uuid
        kind = c.varint()
        if kind != 0:
            raise OcdbtError(f"{c.what}: manifest kind {kind} (only the "
                             f"single-file kind 0 is read)")
        c.varint()  # max inline value bytes
        c.varint()  # max decoded node bytes
        c.u8()  # version tree arity log2
        if c.varint() == 1:
            c.fixed(4)  # zstd level
        files = _data_file_table(c, "")
        n = c.varint()
        if n == 0:
            raise OcdbtError(f"{c.what}: the manifest holds no version")
        c.varints(n)  # generation numbers
        heights = [c.u8() for _ in range(n)]
        ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)  # statistics
        for _ in range(n):
            c.fixed(8)  # commit time
        if offsets[-1] == _EMPTY:
            return 0, None
        return heights[-1], (_file_id(c, files, ids[-1]), offsets[-1],
                             lengths[-1])

    def _node(self, ref) -> memoryview:
        data_file, offset, length = ref
        data = self._file(data_file)
        if offset + length > len(data):
            raise OcdbtError(f"{data_file.path}: node at [{offset}, "
                             f"{offset + length}) lies past the file's "
                             f"{len(data)} bytes")
        return _unframe(memoryview(data)[offset:offset + length], NODE_MAGIC,
                        f"{data_file.path}@{offset}")

    def _walk(self, ref, height: int, prefix: bytes) -> None:
        what = f"{ref[0].path}@{ref[1]}"
        c = _Cursor(self._node(ref), what)
        got = c.u8()
        if got != height:
            raise OcdbtError(f"{what}: node height {got}, its parent says "
                             f"{height}")
        files = _data_file_table(c, ref[0].base)
        n = c.varint()
        keys, commons = _keys(c, n, common=height > 0)
        if height > 0:
            ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)  # statistics
            c.done()
            for key, common, i, offset, length in zip(
                    keys, commons, ids, offsets, lengths):
                if common > len(key):
                    raise OcdbtError(f"{what}: subtree prefix of {common} "
                                     f"bytes on a {len(key)}-byte key")
                self._walk((_file_id(c, files, i), offset, length),
                           height - 1, prefix + key[:common])
            return
        lengths = c.varints(n)
        kinds = c.varints(n)
        indirect = [i for i, kind in enumerate(kinds) if kind == 1]
        if len(indirect) + kinds.count(0) != n:
            raise OcdbtError(f"{what}: value kinds other than 0 and 1")
        ids = c.varints(len(indirect))
        offsets = c.varints(len(indirect))
        refs = {i: (_file_id(c, files, f), o, lengths[i])
                for i, f, o in zip(indirect, ids, offsets)}
        for i, key in enumerate(keys):
            self._index[prefix + key] = refs[i] if kinds[i] else c.take(
                lengths[i])
        c.done()
