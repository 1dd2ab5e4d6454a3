"""The import guard: what a run loads holds no module whose top-level name
is ``jax``, ``jaxlib``, ``flax`` or ``jcfszxc_unet_tpu`` (whole names: the
port's ``jcfszxc_unet_tpu_torch`` passes), and the references load
nothing of the port."""

import ast
import glob
import json
import os
import subprocess
import sys

from harness import common

BENCH = common.BENCH_DIR
ROOT = common.ROOT

RUN_AND_LIST = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
sys.path.insert(0, {tests!r})
import tiny
res, checks = tiny.run({cell!r}, trace=True)
print(json.dumps(sorted(sys.modules)))
"""


def _modules_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=900,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_whole_names():
    assert common.blocked_modules(["jcfszxc_unet_tpu_torch",
                                   "jcfszxc_unet_tpu_torch.models"]) == []
    assert common.blocked_modules(["jcfszxc_unet_tpu.models", "jaxlib.xla",
                                   "flax", "jaxtyping"]) == [
        "flax", "jaxlib.xla", "jcfszxc_unet_tpu.models"]


def test_run_loads_nothing_blocked():
    for cell in ("unet.eval_tiled", "unet.train"):
        mods = _modules_after(RUN_AND_LIST.format(
            bench=BENCH, root=ROOT, tests=os.path.join(BENCH, "tests"),
            cell=cell))
        assert "jcfszxc_unet_tpu_torch" in mods
        assert common.blocked_modules(mods) == []


def test_references_load_nothing_of_the_port():
    code = ("import json, sys\nsys.path[:0] = [%r]\n"
            "from harness import common\n"
            "for n in ('unet', 'nestedunet'):\n"
            "    common.reference_module(n).build()\n"
            "import reference.protocol\n"
            "print(json.dumps(sorted(sys.modules)))\n" % BENCH)
    mods = _modules_after(code)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jcfszxc_unet_tpu_torch", "jcfszxc_unet_tpu", "jax",
                       "jaxlib", "flax"}


def test_reference_sources_import_only_torch_numpy_and_each_other():
    allowed = {"__future__", "contextlib", "math", "numpy", "torch",
               "reference"}
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, (path, name)
