"""JAX variables -> the port's ``state_dict``.

Turns a Flax variables tree of the JAX package (``{"params": ...,
"batch_stats": ...}`` as nested dicts of numpy arrays) into a state dict
with the reference's torch key names, which the port's modules load with
``strict=True``.  The port keeps its own copy of the mapping rules for the
ported models (UNet), independent of the JAX package; the leaf transforms
are those of the reference interchange:

  * Conv2d:          flax kernel (kh, kw, I, O) -> torch (O, I, kh, kw)
  * ConvTranspose2d: flax kernel (kh, kw, I, O), spatially flipped ->
                     torch (I, O, kh, kw)
  * BatchNorm:       scale/bias + batch_stats mean/var -> weight/bias +
                     running_mean/running_var, num_batches_tracked = 0
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

_AUTO_NAME = re.compile(r"^(.+)_(\d+)$")

LEAF_CLASSES = {"Conv2d", "ConvTranspose2d", "BatchNorm2d"}

# Flax child segment -> (torch relative path, class), per block class
# (reference unet_parts.py:17-79).
CHILD_RULES: Dict[str, Dict[str, tuple]] = {
    "DoubleConv": {"Conv2d_0": ("double_conv.0", "Conv2d"),
                   "BatchNorm2d_0": ("double_conv.1", "BatchNorm2d"),
                   "Conv2d_1": ("double_conv.3", "Conv2d"),
                   "BatchNorm2d_1": ("double_conv.4", "BatchNorm2d")},
    "Down": {"DoubleConv_0": ("maxpool_conv.1", "DoubleConv")},
    "Up": {"ConvTranspose2d_0": ("up", "ConvTranspose2d"),
           "DoubleConv_0": ("conv", "DoubleConv")},
    "OutConv": {"Conv2d_0": ("conv", "Conv2d")},
}


def _root_unet(seg):
    if seg == "inc":
        return seg, "DoubleConv"
    if seg.startswith("down"):
        return seg, "Down"
    if seg.startswith("up"):
        return seg, "Up"
    if seg == "outc":
        return seg, "OutConv"
    raise KeyError(seg)


ROOT_RULES = {"UNet.UNet": _root_unet}
_ALIASES = {name.split(".")[-1]: name for name in ROOT_RULES}


class MappingError(RuntimeError):
    pass


def state_dict_from_jax(model_name: str, variables: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """Map JAX ``variables`` of ``model_name`` to the port's state dict
    (float32 tensors; ``num_batches_tracked`` int64 zeros)."""
    model_name = _ALIASES.get(model_name, model_name)
    if model_name not in ROOT_RULES:
        raise MappingError(
            f"no mapping rules for model {model_name!r} (not ported yet)")
    root = ROOT_RULES[model_name]
    out: Dict[str, torch.Tensor] = {}

    def emit(key, arr):
        if key in out:
            raise MappingError(f"duplicate torch key {key!r}")
        a = np.asarray(arr)
        if a.dtype != np.int64:
            a = a.astype(np.float32)
        out[key] = torch.from_numpy(np.ascontiguousarray(a))

    def leaf(cls, prefix, params, stats):
        if cls == "Conv2d":
            emit(prefix + ".weight",
                 np.transpose(params["conv"]["kernel"], (3, 2, 0, 1)))
            if "bias" in params["conv"]:
                emit(prefix + ".bias", params["conv"]["bias"])
        elif cls == "ConvTranspose2d":
            k = np.asarray(params["conv"]["kernel"])[::-1, ::-1]
            emit(prefix + ".weight", np.transpose(k, (2, 3, 0, 1)))
            if "bias" in params["conv"]:
                emit(prefix + ".bias", params["conv"]["bias"])
        else:  # BatchNorm2d
            emit(prefix + ".weight", params["bn"]["scale"])
            emit(prefix + ".bias", params["bn"]["bias"])
            emit(prefix + ".running_mean", stats["bn"]["mean"])
            emit(prefix + ".running_var", stats["bn"]["var"])
            emit(prefix + ".num_batches_tracked", np.array(0, np.int64))

    def walk(params, stats, cls, prefix):
        if cls in LEAF_CLASSES:
            leaf(cls, prefix, params, stats)
            return
        for seg, sub in params.items():
            if cls is None:
                try:
                    rel, sub_cls = root(seg)
                except KeyError:
                    raise MappingError(
                        f"no root rule for {seg!r} in {model_name}") from None
            else:
                if seg not in CHILD_RULES[cls]:
                    raise MappingError(
                        f"no rule for child {seg!r} of {cls!r} at {prefix!r}")
                rel, sub_cls = CHILD_RULES[cls][seg]
            sub_prefix = f"{prefix}.{rel}" if prefix else rel
            walk(sub, (stats or {}).get(seg, {}), sub_cls, sub_prefix)

    walk(variables.get("params", {}), variables.get("batch_stats", {}),
         None, "")
    return out
