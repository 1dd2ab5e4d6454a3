"""zarr v2 arrays over a key-value store, as Orbax writes them: through
tensorstore into an OCDBT store (``compat/ocdbt.py``), or as plain files
(:class:`DirectoryStore`, the layout the port writes).

An array ``name`` is its metadata ``name/.zarray`` (JSON: ``shape``,
``chunks``, ``dtype``, ``compressor``, ``fill_value``, ``filters``,
``order``, ``dimension_separator``, ``zarr_format``) and its chunks
``name/<i>.<j>...`` (``name/0`` for a 0-d array), each the C-order bytes
of one chunk, whole even at the array's edge, compressed with zstd or
stored raw.  Read: compressor ``zstd`` or none, filters none, order C,
separator ``.``, and the dtypes of :data:`DTYPES`; anything else raises
``ValueError`` naming it.  A missing chunk reads as ``fill_value`` (0
when it is null).  ``bfloat16`` comes back as ``torch.bfloat16``, as in
``compat/msgpack.py``.

Arrays come back as CPU tensors.  A chunk is decoded straight into the
tensor's storage when it is the whole array, else into one chunk buffer
that is then cropped into place.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Optional

import numpy as np
import torch

from jcfszxc_unet_tpu_torch.compat import zstd

DTYPES = {"<f4": torch.float32, "<f8": torch.float64, "<f2": torch.float16,
          "bfloat16": torch.bfloat16, "<i4": torch.int32, "<i8": torch.int64,
          "|u1": torch.uint8, "|b1": torch.bool}
_ZARR_DTYPE = {v: k for k, v in DTYPES.items()}
_FILL = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


def _inside(root: str, key: str) -> str:
    rel = os.path.normpath(key)
    if os.path.isabs(rel) or rel == ".." or rel.startswith(".." + os.sep):
        raise ValueError(f"key {key!r} leaves the directory {root}")
    return os.path.join(root, rel)


class DirectoryStore:
    """Keys as files under a directory (``name/.zarray``, ``name/0.0``)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(_inside(self.root, key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 tensor (a view)."""
    return t.reshape(-1).view(torch.uint8)


def _chunk_key(name: str, index) -> str:
    return f"{name}/" + (".".join(map(str, index)) if index else "0")


def read_array(store, name: str) -> torch.Tensor:
    """The zarr v2 array ``name`` of ``store`` (an object whose
    ``get(key)`` returns a buffer, or None for a missing key)."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"no zarr array {name!r} ({name}/.zarray is missing)")
    meta = json.loads(bytes(raw))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')!r}, "
                         f"only 2 is read")
    if meta["dtype"] not in DTYPES:
        raise ValueError(f"{name}: dtype {meta['dtype']!r} is not read (read: "
                         f"{sorted(DTYPES)})")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor!r} is not read "
                         f"(read: zstd or none)")
    if meta.get("filters"):
        raise ValueError(f"{name}: filters {meta['filters']!r} are not read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: order {meta['order']!r} is not read "
                         f"(read: C)")
    sep = meta.get("dimension_separator", ".")
    if sep != ".":
        raise ValueError(f"{name}: dimension_separator {sep!r} is not read "
                         f"(read: '.')")
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} do not fit shape {shape}")
    dtype = DTYPES[meta["dtype"]]
    out = torch.empty(shape, dtype=dtype)
    if out.numel() == 0:
        return out
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    whole = chunks == shape
    buf = out if whole else torch.empty(chunks, dtype=dtype)
    fill = meta.get("fill_value")
    fill = _FILL.get(fill, fill) if fill is not None else 0
    for index in itertools.product(*map(range, grid)):
        key = _chunk_key(name, index)
        data = store.get(key)
        if data is None:
            buf.fill_(fill)
        elif compressor is None:
            if len(data) != buf.numel() * buf.element_size():
                raise ValueError(f"{key}: {len(data)} bytes, a chunk holds "
                                 f"{buf.numel() * buf.element_size()}")
            _flat_bytes(buf).numpy()[:] = np.frombuffer(data, np.uint8)
        else:
            n = zstd.decompress_into(data, buf)
            if n != buf.numel() * buf.element_size():
                raise ValueError(f"{key}: decodes to {n} bytes, a chunk "
                                 f"holds {buf.numel() * buf.element_size()}")
        if not whole:
            lo = [i * c for i, c in zip(index, chunks)]
            hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
            out[tuple(map(slice, lo, hi))] = buf[
                tuple(slice(0, b - a) for a, b in zip(lo, hi))]
    return out


def write_array(root: str, name: str, t: torch.Tensor) -> None:
    """Writes CPU tensor ``t`` under directory ``root`` as the zarr v2
    array ``name``: one raw chunk (compressor null), C order."""
    if t.dtype not in _ZARR_DTYPE:
        raise ValueError(f"{name}: dtype {t.dtype} is not written (written: "
                         f"{sorted(map(str, _ZARR_DTYPE))})")
    if t.numel() == 0:
        raise ValueError(f"{name}: cannot save an array of zero size "
                         f"{tuple(t.shape)}")
    t = t.contiguous()
    meta = {"chunks": list(t.shape), "compressor": None,
            "dimension_separator": ".", "dtype": _ZARR_DTYPE[t.dtype],
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(t.shape), "zarr_format": 2}
    folder = _inside(root, name)
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, ".zarray"), "w") as f:
        json.dump(meta, f)
    with open(_inside(root, _chunk_key(name, [0] * t.dim())), "wb") as f:
        f.write(memoryview(_flat_bytes(t).numpy()))
