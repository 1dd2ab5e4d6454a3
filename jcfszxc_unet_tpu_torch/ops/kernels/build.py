"""Builds the hand-written Hopper kernels and loads them with ``ctypes``;
launch bookkeeping shared by their wrappers.

Every ``*.cu`` under ``jcfszxc_unet_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` (one ``nvcc`` process per source, all started
together), linked into one shared library with a plain C interface and
loaded with ``ctypes``; no PyTorch headers are involved, so a build takes
seconds.  The library is built at first use into ``build/kernels/<hash>/``
under the repository root, keyed by a hash of the sources and the flags,
so that a fresh checkout builds it by itself and an edited source is
never served from a stale build.

Nothing here runs at import time: the CPU tests import every module of
the package on machines without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built on this machine")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path, sources: list[Path]) -> Path:
    nvcc = _nvcc()
    tmp = out_dir.with_name(out_dir.name + f".tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    procs = []
    for src in sources:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"nvcc failed on {failed}; log:\n" + "\n".join(log)[-8000:])
    lib = tmp / "libjcfszxc_kernels.so"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout[-8000:]}")
    build_info["ptxas"] = "\n".join(log)
    try:
        tmp.rename(out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return out_dir / "libjcfszxc_kernels.so"


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv3x3_affine_relu_launch.argtypes = [
        i32, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, i32, i32, vp]
    lib.conv3x3_affine_relu_launch.restype = i32
    lib.dice_sums_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, i32, i64, i64, i32, vp]
    lib.dice_sums_launch.restype = i32
    lib.kernels_error_string.argtypes = [i32]
    lib.kernels_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        if not sources:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        out_dir = BUILD_ROOT / _key(sources)
        so = out_dir / "libjcfszxc_kernels.so"
        build_info.clear()
        build_info["cached"] = so.exists()
        if not so.exists():
            so = _build(out_dir, sources)
        build_info["path"] = str(so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return lib


class LaunchCounter:
    """Launches of one kernel since the last reset; its wrapper adds one
    where it launches the kernel and nowhere else."""

    def __init__(self):
        self.launches = 0

    def reset(self):
        self.launches = 0


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.kernels_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
