"""Tracing, profiling and debug instrumentation, counterpart of
``jcfszxc_unet_tpu/utils/profiling.py``:

  * :func:`trace`: a ``torch.profiler`` capture of the enclosed region
    (the host's operators, and the card's kernels when the run is on
    one), written as a Chrome trace into ``logdir`` (open it in
    ``chrome://tracing`` or Perfetto; the JAX package writes an xprof
    trace);
  * :func:`annotate`: a named span in that trace (``record_function``)
    while a profiler runs, and a shared null context that costs one check
    when none does: the port's spans (``unet.*``) sit on its hot paths;
  * :func:`enable_nan_debugging`: autograd's anomaly mode, which raises at
    the backward of the first operation that made a NaN (the JAX package
    flips ``jax_debug_nans``); the train step's NaN guard stays the
    production behaviour;
  * :class:`Throughput`: steady-state items/s without the warm-up.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region; on exit write
    ``<logdir>/trace_<pid>_<ns>.json`` (a Chrome trace)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A span called ``name`` in a profiler capture (:func:`trace`, or any
    ``torch.profiler`` run), on the clock of the card's kernels.  Without
    a running profiler it returns one shared null context and builds no
    ``record_function``, which costs microseconds a span even when
    nothing records it."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def enable_nan_debugging(enable: bool = True) -> None:
    """Turn autograd's anomaly detection on (or off): a backward that
    makes a NaN raises, naming the forward operation.  Off by default; it
    slows every step."""
    torch.autograd.set_detect_anomaly(enable)


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
