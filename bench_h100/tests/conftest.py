"""The benchmark's own CPU tests: ``python -m pytest bench_h100/tests -q``
from the root of the repository.  They put the benchmark's directory and
the repository's root on ``sys.path``, as ``run.py`` does."""

import os
import sys

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)

torch.set_num_threads(min(4, os.cpu_count() or 1))
