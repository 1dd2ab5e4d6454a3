"""The traced part of a window: a ``torch.profiler`` capture over a bounded,
steady run of units (splits or epochs), from unit ``start`` for ``count``
units, bracketed by device syncs and the span ``bench.traced``.  The
capture stays in memory and is reduced after the window."""

from __future__ import annotations

import time

import torch

from harness.trace import Trace


class Tracer:
    def __init__(self, enabled: bool, start: int, count: int,
                 on_device: bool):
        self.enabled, self.start, self.count_wanted = enabled, start, count
        self.on_device = on_device
        self.prof = self.span = None
        self.count = 0
        self.window_s = 0.0
        self._t0 = 0.0

    def _sync(self):
        if self.on_device:
            torch.cuda.synchronize()

    def pending(self) -> bool:
        return self.enabled and self.count == 0

    def before(self, k: int) -> None:
        if not self.enabled or k != self.start:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_device:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.span = torch.profiler.record_function("bench.traced")
        self.span.__enter__()
        self._t0 = time.perf_counter()

    def after(self, k: int) -> None:
        if not self.enabled or k != self.start + self.count_wanted - 1:
            return
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.count = self.count_wanted

    def trace(self):
        """The reduced capture, or None without one or off the card."""
        if self.prof is None or not self.on_device:
            return None
        return Trace.from_profiler(self.prof)
