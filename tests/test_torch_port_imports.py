"""The PyTorch port stands alone: it imports nothing of JAX, Flax, Optax,
msgpack, the JAX package or the reference shims at the repository root."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "jcfszxc_unet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "jcfszxc_unet_tpu",
             "UNetFamily", "utils")


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
            "compat/torch_export.py", "cli/predict.py"} <= scanned


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
