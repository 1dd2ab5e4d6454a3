"""Model registry of the port, with the JAX package's registry names and
constructor arguments.

Twelve of the zoo's 16 models are ported; any other name raises a
``KeyError`` that says so.
"""

from __future__ import annotations

import inspect

from jcfszxc_unet_tpu_torch.models import (
    AttentionUNet,
    BCDUNet,
    DenseUNet,
    FRUNet,
    MultiResUNet,
    R2AttentionUNet,
    R2UNet,
    ResUNet,
    SegNet,
    UNet,
    UNetPP,
)

MODEL_REGISTRY = {
    "UNet.UNet": UNet.UNet,
    "AttentionUNet.AttentionUNet": AttentionUNet.AttentionUNet,
    "R2UNet.R2UNet": R2UNet.R2UNet,
    "R2AttentionUNet.R2AttentionUNet": R2AttentionUNet.R2AttentionUNet,
    "ResUNet.ResUNet": ResUNet.ResUNet,
    "SegNet.SegNet": SegNet.SegNet,
    "UNetPP.NestedUNet": UNetPP.NestedUNet,
    "BCDUNet.BCDU_net_D3": BCDUNet.BCDU_net_D3,
    "BCDUNet.BCDU_net_D1": BCDUNet.BCDU_net_D1,
    "MultiResUNet.MultiResUNet": MultiResUNet.MultiResUNet,
    "DenseUNet.DenseUNet": DenseUNet.DenseUNet,
    "FRUNet.FRUNet": FRUNet.FRUNet,
}

# Short aliases: bare class names resolve too.
_ALIASES = {name.split(".")[-1]: cls for name, cls in MODEL_REGISTRY.items()}


def resolve_model(name: str):
    """Return the model class for a registry name or bare-class alias."""
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if name in _ALIASES:
        return _ALIASES[name]
    raise KeyError(
        f"model {name!r} is not ported to PyTorch yet (or is unknown); "
        f"ported: {sorted(MODEL_REGISTRY)}")


def registry_name(name: str) -> str:
    """The registry name of a registry name or bare-class alias."""
    cls = resolve_model(name)
    return next(n for n, c in MODEL_REGISTRY.items() if c is cls)


def create_model(name: str, **kwargs):
    """Instantiate a model from the registry by name."""
    return resolve_model(name)(**kwargs)


def model_takes(name: str, arg: str) -> bool:
    """Whether the constructor of model ``name`` has parameter ``arg``."""
    return arg in inspect.signature(resolve_model(name)).parameters


def logit_head_capable():
    """Registry names of the ported models that take ``logit_head``: those
    whose reference forward ends in a sigmoid that training squashes
    again (BCDUNet.py:144/251).  With it set they return the head before
    the sigmoid (the train CLI's ``--logit-head``; same parameters)."""
    return sorted(name for name in MODEL_REGISTRY
                  if model_takes(name, "logit_head"))
