"""Launching a data-parallel job from one process: :func:`spawn` starts
``n`` ranks with ``multiprocessing``'s spawn method, joins them into one
process group through a ``file://`` store in a fresh temporary
directory, runs ``fn(world, *args)`` in each and returns the ranks'
results in rank order.

A child imports ``fn`` by its module path, so ``fn`` must be a function
at the top level of an importable module; the children import torch, the
port and that module, nothing of the caller's ``__main__`` beyond what
``multiprocessing`` imports itself.  Results cross back pickled: return
host values (numpy arrays, CPU tensors, numbers).

Any rank's failure (an exception, or an exit without a result) stops the
others and re-raises in the parent: a ``SystemExit`` with its message,
anything else as a ``RuntimeError`` that carries the rank's traceback.
A collective that hangs fails in its rank after the group's timeout,
which ends the job the same way; ``join_timeout_s`` bounds the whole job
as well.
"""

from __future__ import annotations

import logging
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.multiprocessing as mp

from jcfszxc_unet_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    initialize_distributed,
    shutdown,
)
from jcfszxc_unet_tpu_torch.utils.device import resolve_device


def _child(rank: int, n: int, init_method: str, device, backend, timeout_s,
           threads: int, fn: Callable, args: Sequence, results) -> None:
    torch.set_num_threads(threads)
    try:
        world = initialize_distributed(init_method, n, rank, local_rank=rank,
                                       device=device, backend=backend,
                                       timeout_s=timeout_s)
        try:
            out = fn(world, *args)
        finally:
            shutdown(world)
        results.put((rank, "ok", pickle.dumps(out)))
    except SystemExit as e:
        results.put((rank, "exit", str(e.code)))
        raise
    except Exception:  # the parent raises it, and stops the other ranks
        results.put((rank, "error", traceback.format_exc()))
        raise


def rank_logging(world) -> None:
    """Logging of a spawned CLI rank: rank 0 at INFO, the others at
    WARNING, each line tagged with its rank."""
    logging.basicConfig(
        level=logging.INFO if world.is_main else logging.WARNING,
        format=f"%(levelname)s [rank {world.rank}]: %(message)s")


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()


def spawn(fn: Callable, n: int, *args, device="cuda",
          backend: Optional[str] = None,
          timeout_s: Optional[float] = DEFAULT_TIMEOUT_S,
          join_timeout_s: Optional[float] = None) -> list:
    """Run ``fn(world, *args)`` in ``n`` ranks on ``device`` (``cuda``, the
    default: one card per rank; ``cuda:N``: all on card N, which takes
    ``backend="gloo"``; ``cpu`` only when asked for) and return the ``n``
    results in rank order.  A CUDA device raises here when CUDA is
    missing.  ``timeout_s`` is the group's collective timeout (None:
    torch's default).  Each child gets the caller's torch thread count."""
    device = resolve_device(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="jcfszxc_dist_")
    init_method = "file://" + os.path.join(store_dir, "store")
    procs = [ctx.Process(
        target=_child, name=f"rank{rank}",
        args=(rank, n, init_method, str(device), backend, timeout_s,
              torch.get_num_threads(), fn, args, results))
        for rank in range(n)]
    deadline = None if join_timeout_s is None else (
        time.monotonic() + join_timeout_s)
    out = [None] * n
    try:
        for p in procs:
            p.start()
        pending = set(range(n))
        while pending:
            try:
                rank, kind, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p for r, p in enumerate(procs)
                        if r in pending and not p.is_alive()]
                if dead:
                    # a rank may have put its result just before exiting
                    time.sleep(0.5)
                    if results.empty():
                        raise RuntimeError(
                            f"{dead[0].name} exited with code "
                            f"{dead[0].exitcode} and no result") from None
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{n} ranks still running after {join_timeout_s} s "
                        f"(waiting for ranks {sorted(pending)})") from None
                continue
            if kind == "exit":
                raise SystemExit(payload)
            if kind == "error":
                raise RuntimeError(f"rank {rank} of {n} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
            pending.discard(rank)
        for p in procs:
            p.join(60)
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    return out
