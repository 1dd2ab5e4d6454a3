"""The port's single-file checkpoint: ``torch.save`` of
``{"model_name", "model_kwargs", "state_dict"}`` plus, for a full training
state (``--latest-path``), an ``extra`` dict holding the optimizer's
``state_dict``, the plateau scheduler's fields and the progress.  The
counterpart of the JAX package's msgpack ``save_model``/``load_model``/
``load_extra`` (``jcfszxc_unet_tpu/train/checkpoint.py``).

Writes are synchronous (temporary file, then rename).  Background writes
(``AsyncCheckpointWriter``) and reading a JAX msgpack ``.ckpt`` or a
reference whole-module ``.pth`` are not ported yet; such a file is
refused with a message that says so.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.models import create_model
from jcfszxc_unet_tpu_torch.utils.device import resolve_device

_KEYS = {"model_name", "model_kwargs", "state_dict"}


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_model(path: str, model_name: str, model_kwargs: Dict[str, Any],
               model: nn.Module, extra: Optional[Dict[str, Any]] = None
               ) -> str:
    """Write a checkpoint atomically (temporary file, then rename).
    ``extra`` (tensors, numbers, strings, lists and dicts) is stored
    beside the weights, on the CPU."""
    payload = {
        "model_name": model_name,
        "model_kwargs": dict(model_kwargs),
        "state_dict": _to_cpu(model.state_dict()),
    }
    if extra:
        payload["extra"] = _to_cpu(extra)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _refuse(path: str, why: str):
    return ValueError(
        f"{path} is not a checkpoint of the PyTorch port ({why}). Reading "
        f"JAX msgpack .ckpt files and reference .pth modules is not ported "
        f"yet; convert the weights with compat.from_jax.state_dict_from_jax "
        f"and save them with train.checkpoint.save_model")


def _load(path: str) -> Dict[str, Any]:
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as e:
        raise _refuse(path, f"{type(e).__name__}: {e}"[:200]) from None
    if not isinstance(payload, dict) or not _KEYS <= set(payload):
        raise _refuse(path, f"expected the keys {sorted(_KEYS)}")
    return payload


def load_extra(path: str) -> Optional[Dict[str, Any]]:
    """The ``extra`` dict of a port checkpoint (tensors on the CPU), or
    None when it was saved without one."""
    return _load(path).get("extra")


def load_model(path: str, device="cuda") -> Tuple[nn.Module, Dict[str, Any]]:
    """Rebuild (model, config) from a port checkpoint; the model is in
    eval mode, in channels_last, on ``device`` (the card unless the caller
    asks for the CPU)."""
    device = resolve_device(device)
    payload = _load(path)
    model = create_model(payload["model_name"], **payload["model_kwargs"])
    model.load_state_dict(payload["state_dict"], strict=True)
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    config = {"model_name": payload["model_name"],
              "model_kwargs": payload["model_kwargs"]}
    return model, config
