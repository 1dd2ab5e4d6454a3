"""The port's single-file checkpoint: ``torch.save`` of
``{"model_name", "model_kwargs", "state_dict"}``, the counterpart of the
JAX package's msgpack ``save_model``/``load_model``
(``jcfszxc_unet_tpu/train/checkpoint.py``).

Reading a JAX msgpack ``.ckpt`` or a reference whole-module ``.pth`` is not
ported yet; such a file is refused with a message that says so.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Tuple

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.models import create_model

_KEYS = {"model_name", "model_kwargs", "state_dict"}


def save_model(path: str, model_name: str, model_kwargs: Dict[str, Any],
               model: nn.Module) -> str:
    """Write a checkpoint atomically (temporary file, then rename)."""
    payload = {
        "model_name": model_name,
        "model_kwargs": dict(model_kwargs),
        "state_dict": {k: v.detach().cpu()
                       for k, v in model.state_dict().items()},
    }
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


def load_model(path: str, device="cpu") -> Tuple[nn.Module, Dict[str, Any]]:
    """Rebuild (model, config) from a port checkpoint; the model is in
    eval mode, in channels_last, on ``device``."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as e:
        raise _refuse(path, f"{type(e).__name__}: {e}"[:200]) from None
    if not isinstance(payload, dict) or not _KEYS <= set(payload):
        raise _refuse(path, f"expected the keys {sorted(_KEYS)}")
    model = create_model(payload["model_name"], **payload["model_kwargs"])
    model.load_state_dict(payload["state_dict"], strict=True)
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    config = {"model_name": payload["model_name"],
              "model_kwargs": payload["model_kwargs"]}
    return model, config
