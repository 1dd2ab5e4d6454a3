"""A msgpack decoder for the trees that Flax's ``msgpack_serialize`` writes
(the JAX package's ``.ckpt`` files), so that the port reads them without
``msgpack`` or ``flax``.

The subset is that of ``flax.serialization`` (0.12): maps, arrays, str,
bin, nil, bool, ints of every width, float32/float64, and three ext types
whose payload is itself msgpack:

* 1, ndarray: an array ``(shape, dtype name, C-order bytes)``;
* 2, complex: an array ``(real, imag)``;
* 3, numpy scalar: an ndarray payload of shape ``()``.

Array leaves are views of the buffer handed to :func:`unpackb` (no copy).
``bfloat16`` leaves, which numpy cannot hold, come back as
``torch.bfloat16`` tensors over the same bytes.  Leaves that Flax split at
``MAX_CHUNK_SIZE`` (``{"__msgpack_chunked_array__": True, "shape": ...,
"chunks": ...}``) are joined again.  Any other ext type or tag raises
``ValueError``.  There is no writer: the port never writes a JAX file.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

# tag -> struct format of a fixed-width big-endian number
_NUMBERS = {0xca: ">f", 0xcb: ">d",
            0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# tag -> struct format of the length field of str, bin, array, map, ext
_STR = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_BIN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
_ARRAY = {0xdc: ">H", 0xdd: ">I"}
_MAP = {0xde: ">H", 0xdf: ">I"}
_EXT = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def unpackb(data) -> Any:
    """Decode one msgpack object that fills ``data`` (any buffer: bytes,
    bytearray, mmap, memoryview).  A writable buffer gives writable
    array leaves."""
    view = memoryview(data).cast("B")
    obj, end = _decode(view, 0)
    if end != len(view):
        raise ValueError(f"{len(view) - end} trailing bytes after the "
                         f"msgpack object")
    return _unchunk(obj)


def _length(view, pos, fmt) -> Tuple[int, int]:
    return struct.unpack_from(fmt, view, pos)[0], pos + struct.calcsize(fmt)


def _take(view, pos, n):
    if pos + n > len(view):
        raise ValueError(f"msgpack data ends inside an object at byte {pos}")
    return view[pos:pos + n], pos + n


def _decode(view, pos):
    if pos >= len(view):
        raise ValueError("msgpack data ends where an object was expected")
    tag = view[pos]
    pos += 1
    if tag <= 0x7f:
        return tag, pos
    if tag >= 0xe0:
        return tag - 0x100, pos
    if 0x80 <= tag <= 0x8f:
        return _map(view, pos, tag & 0x0f)
    if 0x90 <= tag <= 0x9f:
        return _array(view, pos, tag & 0x0f)
    if 0xa0 <= tag <= 0xbf:
        raw, pos = _take(view, pos, tag & 0x1f)
        return str(raw, "utf-8"), pos
    if tag == 0xc0:
        return None, pos
    if tag in (0xc2, 0xc3):
        return tag == 0xc3, pos
    if tag in _NUMBERS:
        fmt = _NUMBERS[tag]
        return struct.unpack_from(fmt, view, pos)[0], pos + struct.calcsize(fmt)
    if tag in _STR:
        n, pos = _length(view, pos, _STR[tag])
        raw, pos = _take(view, pos, n)
        return str(raw, "utf-8"), pos
    if tag in _BIN:
        raw, pos = _bin(view, pos - 1)
        return bytes(raw), pos
    if tag in _ARRAY:
        n, pos = _length(view, pos, _ARRAY[tag])
        return _array(view, pos, n)
    if tag in _MAP:
        n, pos = _length(view, pos, _MAP[tag])
        return _map(view, pos, n)
    if tag in _EXT or tag in _FIXEXT:
        if tag in _EXT:
            n, pos = _length(view, pos, _EXT[tag])
        else:
            n = _FIXEXT[tag]
        code = struct.unpack_from(">b", view, pos)[0]
        payload, pos = _take(view, pos + 1, n)
        return _ext(code, payload), pos
    raise ValueError(f"msgpack tag 0x{tag:02x} at byte {pos - 1} is not "
                     f"one that Flax writes")


def _array(view, pos, n):
    out = []
    for _ in range(n):
        item, pos = _decode(view, pos)
        out.append(item)
    return out, pos


def _map(view, pos, n):
    out = {}
    for _ in range(n):
        key, pos = _decode(view, pos)
        out[key], pos = _decode(view, pos)
    return out, pos


def _ext(code, payload):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    if code == EXT_COMPLEX:
        (re, im), end = _decode(payload, 0)
        return complex(re, im)
    raise ValueError(f"msgpack ext type {code} is not one that Flax writes "
                     f"(1 ndarray, 2 complex, 3 numpy scalar)")


def _bin(view, pos):
    """The bin object at ``pos`` as a memoryview of ``view`` (no copy)."""
    tag = view[pos]
    if tag not in _BIN:
        raise ValueError(f"expected msgpack bin at byte {pos}, found tag "
                         f"0x{tag:02x}")
    n, pos = _length(view, pos + 1, _BIN[tag])
    return _take(view, pos, n)


def _ndarray(payload):
    if len(payload) == 0 or payload[0] != 0x93:  # a fixarray of 3
        raise ValueError("ndarray payload is not a 3-element array")
    shape, pos = _decode(payload, 1)
    name, pos = _decode(payload, pos)
    buf, pos = _bin(payload, pos)
    if pos != len(payload):
        raise ValueError("trailing bytes in an ndarray payload")
    name = name if isinstance(name, str) else name.decode()
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        if len(buf) == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(buf, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """Join the leaves Flax split at ``MAX_CHUNK_SIZE``."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED) is True:
        shape = tuple(int(tree["shape"][str(i)])
                      for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}
