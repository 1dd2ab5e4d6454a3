"""Checkpoints of the port, counterpart of
``jcfszxc_unet_tpu/train/checkpoint.py``.

The port's own file is ``torch.save`` of ``{"model_name", "model_kwargs",
"state_dict"}`` plus, for a full training state (``--latest-path``), an
``extra`` dict holding the optimizer's ``state_dict``, the plateau
scheduler's fields and the progress.  It is written atomically (temporary
file, then rename), in the foreground (:func:`save_model`) or in the
background (:class:`AsyncCheckpointWriter`).

:func:`load_model_any` reads the three formats the JAX package reads.  It
sniffs the format from the file's first bytes and hands the file to
exactly one reader, which raises if it fails:

* the port's own file (a torch zip holding the keys above);
* a JAX msgpack ``.ckpt`` (:func:`load_jax_ckpt`: the port's msgpack
  reader and weight bridge, no JAX);
* a reference ``.pth``: a whole pickled module, a bare state dict or a
  ``{"model_state_dict": ...}`` bundle (``compat/torch_import.py``).

:func:`load_extra` reads the port's file only: exact resume needs the
port's optimizer state.
"""

from __future__ import annotations

import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from jcfszxc_unet_tpu_torch.compat import msgpack
from jcfszxc_unet_tpu_torch.compat.from_jax import state_dict_from_jax
from jcfszxc_unet_tpu_torch.compat.torch_import import (
    infer_model_name,
    model_from_state_dict,
    model_name_of,
    read_pth,
    state_dict_of,
)
from jcfszxc_unet_tpu_torch.models import model_takes
from jcfszxc_unet_tpu_torch.utils.device import resolve_device

_KEYS = {"model_name", "model_kwargs", "state_dict"}

# JAX model kwargs that are not architecture: the compute dtype (the
# port's is an argument of its entry points) and space-to-depth execution
# (same parameter tree; the port's models refuse it).
_JAX_ONLY_KWARGS = ("dtype", "s2d")


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _to_cpu(tree):
    return _map_tensors(lambda t: t.detach().cpu(), tree)


def save_state(path: str, model_name: str, model_kwargs: Dict[str, Any],
               state_dict: Dict[str, torch.Tensor],
               extra: Optional[Dict[str, Any]] = None) -> str:
    """Write a checkpoint of ``state_dict`` atomically (temporary file,
    then rename).  ``extra`` (tensors, numbers, strings, lists and dicts)
    is stored beside the weights, on the CPU."""
    payload = {
        "model_name": model_name,
        "model_kwargs": dict(model_kwargs),
        "state_dict": _to_cpu(dict(state_dict)),
    }
    if extra:
        payload["extra"] = _to_cpu(extra)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_model(path: str, model_name: str, model_kwargs: Dict[str, Any],
               model: nn.Module, extra: Optional[Dict[str, Any]] = None
               ) -> str:
    """:func:`save_state` of ``model``'s state dict."""
    return save_state(path, model_name, model_kwargs, model.state_dict(),
                      extra)


# ---------------------------------------------------------------------------
# Reading: format sniffing and the three readers
# ---------------------------------------------------------------------------

def checkpoint_format(path: str) -> str:
    """``"torch"`` (a torch zip, ``PK\\x03\\x04``, or a legacy pickle,
    ``\\x80`` and a protocol byte 2-5) or ``"jax"`` (a msgpack map header,
    0x80-0x8f, 0xde or 0xdf: a JAX ``.ckpt``), from the first bytes;
    raises ``ValueError`` for anything else."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return "torch"
    if len(head) >= 2 and head[0] == 0x80 and 2 <= head[1] <= 5:
        return "torch"
    if head and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf)):
        return "jax"
    raise ValueError(
        f"{path} is none of the checkpoint formats the port reads (first "
        f"bytes {head!r}); tried: a torch zip (the port's file or a .pth, "
        f"b'PK\\x03\\x04'), a legacy torch pickle (b'\\x80' and protocol "
        f"2-5) and a JAX msgpack .ckpt (a map header, 0x80-0x8f/0xde/0xdf)")


def _refuse(path: str, why: str):
    return ValueError(
        f"{path} is not a checkpoint of the PyTorch port ({why}); "
        f"load_model_any also reads JAX .ckpt and reference .pth files, "
        f"and --resume needs a port checkpoint")


def _load(path: str) -> Dict[str, Any]:
    if checkpoint_format(path) != "torch":
        raise _refuse(path, "it is a JAX msgpack .ckpt")
    payload = read_pth(path)
    if not isinstance(payload, dict) or not _KEYS <= set(payload):
        raise _refuse(path, f"expected the keys {sorted(_KEYS)}")
    return payload


def load_extra(path: str) -> Optional[Dict[str, Any]]:
    """The ``extra`` dict of a port checkpoint (tensors on the CPU), or
    None when it was saved without one."""
    return _load(path).get("extra")


def _ready(model: nn.Module, device) -> nn.Module:
    return model.to(device=device, memory_format=torch.channels_last).eval()


def _port_model(payload, device):
    model = model_from_state_dict(payload["model_name"], payload["state_dict"],
                                  payload["model_kwargs"], device)
    return model, {"model_name": payload["model_name"],
                   "model_kwargs": payload["model_kwargs"]}


def load_model(path: str, device="cuda") -> Tuple[nn.Module, Dict[str, Any]]:
    """Rebuild (model, config) from a port checkpoint; the model is in
    eval mode, in channels_last, on ``device`` (the card unless the caller
    asks for the CPU)."""
    device = resolve_device(device)
    model, config = _port_model(_load(path), device)
    return _ready(model, device), config


def read_jax_ckpt(path: str) -> Dict[str, Any]:
    """The tree of a JAX ``.ckpt`` (``config`` parsed from its JSON,
    ``params``, ``batch_stats`` and ``extra`` as written), read by the
    port's msgpack reader; array leaves are numpy views of one buffer
    (``torch.bfloat16`` tensors for bf16 leaves)."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)
    payload = msgpack.unpackb(buf)
    payload["config"] = json.loads(payload["config"])
    return payload


def port_kwargs(model_kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """``model_kwargs`` of a JAX checkpoint without the JAX-only keys."""
    return {k: v for k, v in model_kwargs.items()
            if k not in _JAX_ONLY_KWARGS}


def _f32_numpy(tree):
    if isinstance(tree, dict):
        return {k: _f32_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):  # bf16 leaves
        return tree.float().numpy()
    return np.asarray(tree)


def load_jax_ckpt(path: str, device="cuda"
                  ) -> Tuple[nn.Module, Dict[str, Any]]:
    """Rebuild (model, config) from a JAX msgpack ``.ckpt`` (JAX
    ``load_model``): the port's model of the recorded name and kwargs,
    with ``compat.from_jax.state_dict_from_jax`` of its ``params`` and
    ``batch_stats`` loaded ``strict=True``.  ``s2d`` (an execution mode
    over the same parameters, which the port's models refuse) and
    ``dtype`` are left out of the model's kwargs; ``config`` is the
    file's.  An optax ``opt_state`` in ``extra`` is not read."""
    device = resolve_device(device)
    payload = read_jax_ckpt(path)
    config = payload["config"]
    name, kwargs = config["model_name"], dict(config["model_kwargs"])
    if kwargs.get("s2d"):
        logging.info(f"{path}: loading {name} without s2d (a JAX execution "
                     f"mode over the same parameters)")
    variables = {"params": _f32_numpy(payload["params"]),
                 "batch_stats": _f32_numpy(payload.get("batch_stats", {}))}
    model = model_from_state_dict(name, state_dict_from_jax(name, variables),
                                  port_kwargs(kwargs), device)
    return _ready(model, device), {"model_name": name,
                                   "model_kwargs": config["model_kwargs"]}


def load_model_any(path: str, device="cuda", patch_size: int = 64
                   ) -> Tuple[nn.Module, Dict[str, Any]]:
    """(model, config) from a port checkpoint, a JAX ``.ckpt`` or a
    reference ``.pth`` (JAX ``load_model_any``), in eval mode, in
    channels_last, on ``device`` (the card unless the caller asks for the
    CPU).  A ``.pth``'s model is named by its pickled class or, for a
    bare state dict or bundle, by its keys and shapes; BCDU models get
    ``N = patch_size``."""
    device = resolve_device(device)
    if checkpoint_format(path) == "jax":
        return load_jax_ckpt(path, device)
    obj = read_pth(path)
    if isinstance(obj, dict) and _KEYS <= set(obj):
        model, config = _port_model(obj, device)
    else:
        sd = state_dict_of(obj)
        name = model_name_of(obj) or infer_model_name(sd)
        kwargs = {"N": patch_size} if model_takes(name, "N") else {}
        model = model_from_state_dict(name, sd, kwargs, device)
        config = {"model_name": name, "model_kwargs": kwargs}
    return _ready(model, device), config


# ---------------------------------------------------------------------------
# Background writes
# ---------------------------------------------------------------------------

class AsyncCheckpointWriter:
    """Checkpoint writes off the training loop's critical path (JAX
    ``AsyncCheckpointWriter``): ``submit(fn, *args, **kwargs)`` runs
    ``fn`` on a worker thread.

    Unlike JAX buffers, torch tensors change in place (``optimizer.step``),
    so ``submit`` snapshots every tensor in ``args`` and ``kwargs`` before
    it returns: a clone on the tensor's device, on the current stream (an
    HBM-to-HBM copy on the card), and a CUDA event recorded after it.  The
    worker waits on that event from a stream of its own, copies the clones
    to the host there (never on the legacy default stream, which would
    serialize with the next step's kernels), and calls ``fn`` on the host
    copies.

    One write in flight: ``submit`` first waits for the previous write,
    which bounds the extra device memory to one snapshot and re-raises a
    worker exception at the call site; so do :meth:`wait` and
    :meth:`close`.  Call :meth:`close` (or use the writer as a context
    manager) before relying on the files.
    """

    def __init__(self):
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending = None
        self._stream = None  # the worker's copy stream, made at first use

    def submit(self, fn, *args, **kwargs):
        self.wait()
        devices = set()

        def clone(t):
            if t.is_cuda:
                devices.add(t.device)
            return t.detach().clone()

        snap = _map_tensors(clone, (args, kwargs))
        event = None
        if devices:
            (device,) = devices  # the port runs on one device
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
        self._pending = self._executor.submit(self._run, event, fn, snap)

    def _run(self, event, fn, snap):
        if event is not None:
            with torch.cuda.stream(self._stream):
                self._stream.wait_event(event)
                # a blocking copy syncs this stream only
                snap = _map_tensors(lambda t: t.to("cpu"), snap)
        args, kwargs = snap
        return fn(*args, **kwargs)

    def wait(self):
        """Block until the write in flight (if any) ends; re-raises its
        exception."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self):
        try:
            self.wait()
        finally:
            self._executor.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
