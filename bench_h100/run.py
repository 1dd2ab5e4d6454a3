"""Run one cell of the benchmark once, on the card of this machine:

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up (weights and data from the seed,
the program's kernels built or found in build/, every shape of the
cell's traffic warmed), then a window of ``--seconds`` in which the
traffic runs in a closed loop, then the check of what the window produced
against the plain reference.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``checks``, the
compared numbers beside their limits, which also end standard error).
With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones.  Exits non-zero without printing a
result when the machine has fewer CUDA devices than the cell asks for, or
when a module of the JAX package is loaded."""

from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import common  # noqa: E402


def main(argv=None) -> int:
    args = common.parse_args(argv)
    common.cache_environment()
    bench = common.benchmark()
    cell = common.cell(bench, args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from harness.run_cell import run

    result, checks = run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", common.limits(cell["name"]),
                         t_start=T_START)
    blocked = common.blocked_modules()
    if blocked:
        print(f"run.py: modules of the JAX package loaded: {blocked}",
              file=sys.stderr)
        return 3
    common.print_result(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
