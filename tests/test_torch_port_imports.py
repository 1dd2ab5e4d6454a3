"""The PyTorch port stands alone: it imports nothing of JAX, Flax, Optax,
msgpack, Orbax, tensorstore, zstandard, the JAX package or the reference
shims at the repository root, and its host library links no zstd."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "jcfszxc_unet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "jcfszxc_unet_tpu",
             "UNetFamily", "utils", "orbax", "tensorstore", "zstandard")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_covers_the_checkpoint_interop_modules():
    scanned = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"compat/msgpack.py", "compat/torch_import.py",
            "compat/torch_export.py", "cli/predict.py",
            # the fractal trainer, preprocessing and profiling
            "train/fractal.py", "cli/train_demo.py", "cli/preprocess.py",
            "data/preprocess.py", "utils/profiling.py",
            # space-to-depth execution and the optax state of JAX resumes
            "ops/s2d.py", "compat/optax_state.py",
            # export and the kernels' operators
            "eval/export.py", "ops/kernels/library.py",
            "scripts/op_dispatch_cost.py",
            "scripts/forward_repeatability.py", "scripts/step_cost.py",
            # data-parallel runs
            "parallel/__init__.py", "parallel/mesh.py", "parallel/launch.py",
            "parallel/jobs.py",
            # the row-sharded whole-image forward
            "parallel/spatial.py",
            # Orbax directories and their readers
            "compat/orbax.py", "compat/zarr.py", "compat/ocdbt.py",
            "compat/zstd.py", "compat/host_build.py"} <= scanned


def test_host_library_links_no_zstd():
    """zstd is decoded by the port's own C decoder only: no source includes
    a zstd header, no flag links libzstd, and the built library needs no
    libzstd."""
    from jcfszxc_unet_tpu_torch.compat import host_build

    for src in host_build.HOST_CSRC.glob("*.c"):
        assert "#include <zstd" not in src.read_text(), src.name
    assert not any("zstd" in flag for flag in host_build.CFLAGS)
    lib = host_build.load_host_library()
    out = subprocess.run(["ldd", lib._name], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert "zstd" not in out.stdout


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, jcfszxc_unet_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, "
        "P.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 20
