"""A CUDA graph of one train step's forward, loss and backward, for
``train/trainer.make_batch_step_fn``.

Eager, a UNet step of 32 patches launches ~500 kernels from the host, and
the card waits on the launches.  Captured once and replayed, the forward,
the loss, ``isfinite(loss)`` and the backward are one graph launch after
two copies of the batch into the graph's own input tensors.  An event
recorded inside the graph after ``isfinite(loss)`` lets the NaN guard's
host read (:meth:`StepGraph.finite`) wait for the forward and loss alone:
the host then queues clip, RMSprop and the next step's sampling while the
card runs the backward.

:class:`StepGraph` is the state of one step function:

  * :meth:`StepGraph.route` says how a step runs: a fallback reason where
    the step cannot be captured (``"world"``: gloo's collectives cannot be
    captured; ``"remat"``: ``torch.utils.checkpoint`` reads the RNG state,
    which a capture forbids; ``"device"``: not a CUDA tensor; ``"sync
    seen"``; ``"capture error"``), else ``"warm-up"``, ``"capture"`` or
    ``"replay"``.
  * A graph is keyed on what the step can observe (:func:`graph_key`): the
    model object, its parameters' and buffers' storages, the batch's
    shapes, dtypes and device.  A new key (``model.to``, a replaced
    parameter, a new batch shape) drops the graph, and the next
    ``WARMUP_STEPS`` steps run eagerly, on the capture's side stream (so
    that cuDNN's and cuBLAS's lazy state for that stream is made outside
    the capture), with synchronising calls reported
    (``torch.cuda.set_sync_debug_mode``).  The step after them is captured,
    which runs nothing, and replayed at once.  A warm-up step that saw a
    synchronising call in its forward, loss or backward (a pageable copy,
    a ``.item()``) keeps the step function eager from then on, as does a
    capture that raises; the step that was being captured then runs
    eagerly, so no step is lost.
  * The capture starts with every ``.grad`` None, so the captured backward
    leaves each gradient in the graph's memory, which ``.grad`` keeps
    pointing at and every replay overwrites.  While a graph lives, nothing
    may set a ``.grad`` to None or replace it; a step that finds one
    replaced or None drops the graph and warms up again, as for a new key.

:class:`GraphCounter` counts captures, replays and eager steps with the
reason of each, in the style of the kernels' launch counters."""

from __future__ import annotations

import contextlib
import itertools
import warnings
from typing import Callable, Optional

import torch
from torch import nn

# Eager steps of a new key before its capture: the first makes the lazy
# state (cuDNN's plans, the side stream's library handles and workspaces),
# the second checks a step that finds it all made.
WARMUP_STEPS = 2


class GraphCounter:
    """Steps of one step function: ``captures``, ``replays`` (the captured
    step is replayed once, so it counts in both), ``eager`` steps and, in
    ``reasons``, the eager steps by why they were not replayed:
    ``"warm-up"`` or a fallback reason of :meth:`StepGraph.route`."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self.eager = 0
        self.reasons: dict[str, int] = {}

    def add_eager(self, reason: str) -> None:
        self.eager += 1
        self.reasons[reason] = self.reasons.get(reason, 0) + 1


def graph_key(model: nn.Module, imgs: torch.Tensor,
              labs: torch.Tensor) -> tuple:
    """What a captured step depends on that the step can observe: the
    model object, the addresses of its parameters and buffers (moved or
    replaced by ``model.to`` or a new ``nn.Parameter``, kept by an
    in-place ``load_state_dict``), and the batch's shapes, dtypes and
    device."""
    return (id(model),
            tuple(t.data_ptr() for t in itertools.chain(
                model.parameters(), model.buffers())),
            tuple(imgs.shape), imgs.dtype, tuple(labs.shape), labs.dtype,
            imgs.device)


class _Captured:
    """One captured step: the graph, its input tensors (the batch is
    copied into them) and its outputs, the loss and ``isfinite(loss)``."""

    def __init__(self, key: tuple, model: nn.Module, imgs: torch.Tensor,
                 labs: torch.Tensor):
        self.key, self.model = key, model  # the model: its id stays its own
        self.imgs, self.labs = imgs.clone(), labs.clone()
        self.graph = torch.cuda.CUDAGraph()
        self.loss: Optional[torch.Tensor] = None
        self.finite: Optional[torch.Tensor] = None
        # Recorded inside the graph once ``finite`` is computed, before the
        # backward: each replay records it when it gets there.
        self.flagged = torch.cuda.Event(external=True)
        # (parameter, address of the .grad the capture left)
        self.grads: list = []

    def holds_grads(self) -> bool:
        """Every gradient the capture left is still its parameter's
        ``.grad``, at the same address (a parameter the backward does not
        reach has none)."""
        return all(p.grad is not None and p.grad.data_ptr() == ptr
                   for p, ptr in self.grads)


class StepGraph:
    """The graph of one step function: see the module doc.  ``world`` and
    ``remat`` are the step function's."""

    def __init__(self, *, world=None, remat: bool = False):
        self.counter = GraphCounter()
        self.fixed = ("world" if world is not None
                      else "remat" if remat else None)
        self.stopped: Optional[str] = None  # "sync seen" or "capture error"
        self.captured: Optional[_Captured] = None
        self.warm_key: Optional[tuple] = None
        self.warmed = 0
        self.stream: Optional[torch.cuda.Stream] = None

    def route(self, model: nn.Module, imgs: torch.Tensor,
              labs: torch.Tensor) -> str:
        """How this step runs: ``"replay"``, ``"capture"``, ``"warm-up"``
        or the reason it runs eagerly."""
        reason = self.fixed or self.stopped
        if reason is None and imgs.device.type != "cuda":
            reason = "device"
        if reason is not None:
            self.captured = None  # an eager step sets .grad to None
            return reason
        return self.schedule(graph_key(model, imgs, labs))

    def schedule(self, key: tuple) -> str:
        """``"replay"`` while ``key`` is the captured step's and its
        gradients are held; else the graph is dropped, and a key's first
        ``WARMUP_STEPS`` steps are ``"warm-up"`` and the next
        ``"capture"``."""
        c = self.captured
        if c is not None and c.key == key and c.holds_grads():
            return "replay"
        self.captured = None
        if key != self.warm_key:
            self.warm_key, self.warmed = key, 0
        return "capture" if self.warmed >= WARMUP_STEPS else "warm-up"

    @contextlib.contextmanager
    def warm_up(self):
        """Around an eager warm-up step's forward, loss and backward: run
        them on the capture's side stream, and stop the graph for good if
        they make a synchronising call."""
        main = torch.cuda.current_stream()
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        self.stream.wait_stream(main)
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with torch.cuda.stream(self.stream):
                    yield
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        main.wait_stream(self.stream)
        # The mode's warnings name a synchronising call, or give its own
        # notice that it is a prototype; every other warning goes on.
        for w in seen:
            if "synchroniz" not in str(w.message):
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
            elif "prototype" not in str(w.message):
                self.stopped = "sync seen"
        self.warmed += 1

    def capture(self, model: nn.Module, imgs: torch.Tensor,
                labs: torch.Tensor, body: Callable) -> bool:
        """Capture ``body(model, imgs, labs, mark) -> loss`` (forward, loss,
        ``mark(loss)``, backward) on the graph's own copy of the batch,
        every ``.grad`` None; False, with the graph stopped for good and
        every ``.grad`` None, if the capture raised."""
        captured = _Captured(self.warm_key, model, imgs, labs)

        def mark(loss):
            captured.finite = torch.isfinite(loss)
            captured.flagged.record()

        try:
            # The outer context gives the main stream back even where the
            # capture's own exit raises before it does.
            with torch.cuda.stream(self.stream):
                with torch.cuda.graph(captured.graph, stream=self.stream):
                    captured.loss = body(model, captured.imgs,
                                         captured.labs, mark).detach()
        except RuntimeError:
            for p in model.parameters():
                p.grad = None
            self.stopped = "capture error"
            return False
        captured.grads = [(p, p.grad.data_ptr()) for p in model.parameters()
                          if p.grad is not None]
        self.captured = captured
        self.counter.captures += 1
        return True

    def replay(self, imgs: torch.Tensor, labs: torch.Tensor) -> torch.Tensor:
        """Copy the batch in and replay; the loss, the graph's own tensor,
        which the next replay overwrites."""
        c = self.captured
        c.imgs.copy_(imgs)
        c.labs.copy_(labs)
        c.graph.replay()
        self.counter.replays += 1
        return c.loss

    def finite(self) -> bool:
        """``isfinite(loss)`` of the last replay, read on the host: a sync
        on the side stream, which waits for the replay's forward and loss
        alone, not for its backward."""
        c = self.captured
        self.stream.wait_event(c.flagged)
        with torch.cuda.stream(self.stream):
            return bool(c.finite)

