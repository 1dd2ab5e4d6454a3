"""Builds the port's host C code (``csrc/host/*.c``: the zstd decoder and
CRC-32C of the Orbax reader) and loads it with ``ctypes``.

The sources are compiled by the host C compiler (``$CC``, else ``cc``)
into one shared library with a plain C interface, at first use, into
``build/host/<hash>/`` under the repository root, keyed by a hash of the
sources, the compiler, the machine and the flags.  No ``nvcc`` is
involved, so the library builds on any machine with a C compiler, the CPU
test machines included.  Concurrent processes (test workers) build under
a file lock, into a temporary directory that is then renamed.  A missing
or failing compiler raises with its output; there is no fall-back.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

HOST_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "host"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "host"
CFLAGS = ["-O2", "-std=c11", "-shared", "-fPIC"]
LIB_NAME = "libjcfszxc_host.so"

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    cc = os.environ.get("CC") or "cc"
    path = shutil.which(cc)
    if path is None:
        raise RuntimeError(
            f"C compiler {cc!r} not found ($CC, else cc on PATH): the "
            f"port's host library ({HOST_CSRC}) cannot be built")
    return path


def _key(cc: str, sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join([cc, platform.machine(), *CFLAGS]).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(cc: str, sources: list[Path], out_dir: Path) -> None:
    tmp = out_dir.with_name(f"{out_dir.name}.tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    cmd = [cc, *CFLAGS, "-o", str(tmp / LIB_NAME), *map(str, sources)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"building the host library failed ({' '.join(cmd)}"
                           f"):\n{proc.stdout[-8000:]}")
    tmp.rename(out_dir)


def _declare(lib: ctypes.CDLL) -> None:
    vp, size = ctypes.c_void_p, ctypes.c_size_t
    lib.zstd_decompress.argtypes = [vp, size, vp, size,
                                    ctypes.POINTER(size)]
    lib.zstd_decompress.restype = ctypes.c_int
    lib.zstd_decoded_bound.argtypes = [vp, size,
                                       ctypes.POINTER(ctypes.c_uint64),
                                       ctypes.POINTER(ctypes.c_int)]
    lib.zstd_decoded_bound.restype = ctypes.c_int
    lib.zstd_error_string.argtypes = [ctypes.c_int]
    lib.zstd_error_string.restype = ctypes.c_char_p
    lib.crc32c.argtypes = [vp, size]
    lib.crc32c.restype = ctypes.c_uint32


def load_host_library() -> ctypes.CDLL:
    """Build (if needed) and load the host library; cached per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(HOST_CSRC.glob("*.c"))
        if not sources:
            raise RuntimeError(f"no C sources under {HOST_CSRC}")
        cc = _compiler()
        out_dir = BUILD_ROOT / _key(cc, sources)
        so = out_dir / LIB_NAME
        if not so.exists():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            with open(BUILD_ROOT / f"{out_dir.name}.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not so.exists():  # another process may have built it
                    _build(cc, sources, out_dir)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return lib
