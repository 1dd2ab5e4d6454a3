"""Throughput counter, counterpart of ``Throughput`` in
``jcfszxc_unet_tpu/utils/profiling.py``."""

from __future__ import annotations

import time
from typing import Optional


class Throughput:
    """Steady-state items/s; the first interval (warm-up) is dropped."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None
        self._items = 0
        self._seen_first = False

    def tick(self, n_items: int) -> Optional[float]:
        """Record ``n_items`` processed since the last tick; returns the
        steady-state rate (None until the second tick)."""
        now = time.perf_counter()
        if not self._seen_first:
            self._seen_first = True
            self._t0 = now
            return None
        self._items += n_items
        dt = now - self._t0
        return self._items / dt if dt > 0 else None
