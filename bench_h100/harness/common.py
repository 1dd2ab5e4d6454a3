"""The frame of one run: arguments, the files the benchmark is made of,
seeds, the import guard and the result line."""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# Whole top-level module names the process that prints the result may not
# hold.  The port's package name begins with the last one, so names are
# compared whole, never by prefix.
BLOCKED = ("jax", "jaxlib", "flax", "jcfszxc_unet_tpu")


def blocked_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in BLOCKED)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                     f"{[w['name'] for w in bench['workloads']]}")


def config(name: str) -> dict:
    """configs/<name>.json."""
    return load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    """traffic/<name>.json."""
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def limits(cell_name: str) -> dict:
    """limits/<cell>.json: each compared number's limit (``limit``) and the
    readings it was set from."""
    spec = load_json(os.path.join(BENCH_DIR, "limits", f"{cell_name}.json"))
    return {k: v["limit"] for k, v in spec.items()}


def load_file(path: str, name: str):
    """The module at ``path``; metric readers have dots in their names,
    so they are loaded by path, not by import."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(config_name: str):
    """reference/<config>.py: ``build()`` gives the plain f32 model."""
    return load_file(os.path.join(BENCH_DIR, "reference",
                                  f"{config_name}.py"),
                     f"reference.{config_name}")


@functools.cache
def driver(kind: str):
    """drivers/<kind>.py, the general driver of a traffic kind: ``Driver``
    (the class a run drives), ``NUMBERS`` (the numbers its check can
    compare) and ``FAULTS`` (the faults its tests plant)."""
    path = os.path.join(BENCH_DIR, "drivers", f"{kind}.py")
    if not os.path.exists(path):
        raise SystemExit(f"unknown traffic kind {kind!r}: no {path}")
    return load_file(path, f"bench_driver_{kind}")


def metric_reader(metric: str):
    """metrics/<metric>.py: ``read(readings) -> float | None``."""
    return load_file(os.path.join(BENCH_DIR, "metrics", f"{metric}.py"),
                     f"bench_metric_{metric.replace('.', '_')}")


def subseed(seed: int, *keys) -> int:
    """A 63-bit seed for one purpose of a run: the run's seed (any whole
    number) hashed with the purpose's keys."""
    h = hashlib.sha256(repr((int(seed),) + keys).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def cache_environment(root: str = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so only
    a checkout's first run builds or compiles: torch's extension and
    Triton caches here; the program's own kernel library builds into
    build/kernels/<source hash>/ of the checkout by itself."""
    base = os.path.join(root, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def quantile(values, q: float) -> float:
    """The q-quantile of ``values`` by linear interpolation between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def print_result(result: dict, checks: list) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output,
    with the same numbers under ``checks``, its last key."""
    for c in checks:
        where = f" (worst leaf {c['where']})" if c.get("where") else ""
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}{where}", file=sys.stderr)
    sys.stderr.flush()
    out = dict(result)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    print(json.dumps(out), flush=True)


def check(name: str, value: float, limit: float, where=None) -> dict:
    """One compared number: ok when it is finite and at most its limit;
    ``where`` names the leaf that set it, for the record on stderr."""
    ok = value == value and value <= limit
    return {"name": name, "value": value, "limit": limit, "ok": ok,
            "where": where}
