"""zstd decompression through the port's own decoder
(``csrc/host/zstd_decode.c``, RFC 8878; built by ``compat/host_build.py``).

The Orbax checkpoints of the JAX package hold zstd frames in every OCDBT
node and every zarr chunk (``compat/ocdbt.py``, ``compat/zarr.py``), and
the machine that restores them has no zstd library.  Dictionaries are not
supported.  Malformed input raises ``ValueError``; nothing falls back.
The decoder releases the GIL (a ``ctypes`` call), so threads may decode
in parallel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from jcfszxc_unet_tpu_torch.compat.host_build import load_host_library


def _src(buf) -> np.ndarray:
    return np.frombuffer(buf, dtype=np.uint8)


def _raise(lib, code: int, what: str):
    msg = lib.zstd_error_string(code).decode()
    raise ValueError(f"zstd: {what}: {msg} (code {code})")


def _decode(src: np.ndarray, dst_ptr: int, cap: int) -> int:
    lib = load_host_library()
    written = ctypes.c_size_t(0)
    code = lib.zstd_decompress(src.ctypes.data, src.size, dst_ptr, cap,
                               ctypes.byref(written))
    if code != 0:
        _raise(lib, code, f"cannot decode {src.size} bytes")
    return written.value


def decoded_bound(buf) -> tuple[int, bool]:
    """(an upper bound of the decoded size, whether it is exact) of the
    frames in ``buf``, from their headers."""
    lib = load_host_library()
    src = _src(buf)
    bound, exact = ctypes.c_uint64(0), ctypes.c_int(0)
    code = lib.zstd_decoded_bound(src.ctypes.data, src.size,
                                  ctypes.byref(bound), ctypes.byref(exact))
    if code != 0:
        _raise(lib, code, f"cannot read the frame headers of {src.size} bytes")
    return bound.value, bool(exact.value)


def decompress(buf) -> bytes:
    """The decoded content of every frame in ``buf`` (bytes, bytearray,
    memoryview or mmap), one after another."""
    src = _src(buf)
    out = torch.empty(decoded_bound(src)[0], dtype=torch.uint8)
    return out[:decompress_into(src, out)].numpy().tobytes()


def decompress_into(buf, out: torch.Tensor) -> int:
    """Decodes ``buf`` into the contiguous CPU tensor ``out``, which
    becomes the data's storage with no further copy; returns the number
    of bytes written.  Raises when the data does not fit."""
    if out.device.type != "cpu" or not out.is_contiguous():
        raise ValueError("decompress_into needs a contiguous CPU tensor")
    return _decode(_src(buf), out.data_ptr(), out.numel() * out.element_size())
