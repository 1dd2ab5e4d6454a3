"""Model registry of the port, with the JAX package's registry names and
constructor arguments.

All 16 of the zoo's models are ported, under the JAX names; any other
name raises a ``KeyError`` that lists them.
"""

from __future__ import annotations

import inspect

import torch

from jcfszxc_unet_tpu_torch.models import (
    AttentionUNet,
    BARUNet,
    BCDUNet,
    BIARUNet,
    DenseUNet,
    FRUNet,
    MCUNet,
    MultiResUNet,
    R2AttentionUNet,
    R2UNet,
    ResUNet,
    RetinaLiteNet,
    SegNet,
    UNet,
    UNetPP,
)

MODEL_REGISTRY = {
    "UNet.UNet": UNet.UNet,
    "AttentionUNet.AttentionUNet": AttentionUNet.AttentionUNet,
    "R2UNet.R2UNet": R2UNet.R2UNet,
    "R2AttentionUNet.R2AttentionUNet": R2AttentionUNet.R2AttentionUNet,
    "BARUNet.BARUNet": BARUNet.BARUNet,
    "BIARUNet.BIARUNet": BIARUNet.BIARUNet,
    "DenseUNet.DenseUNet": DenseUNet.DenseUNet,
    "MCUNet.MCUNet": MCUNet.MCUNet,
    "ResUNet.ResUNet": ResUNet.ResUNet,
    "FRUNet.FRUNet": FRUNet.FRUNet,
    "MultiResUNet.MultiResUNet": MultiResUNet.MultiResUNet,
    "SegNet.SegNet": SegNet.SegNet,
    "BCDUNet.BCDU_net_D3": BCDUNet.BCDU_net_D3,
    "BCDUNet.BCDU_net_D1": BCDUNet.BCDU_net_D1,
    "RetinaLiteNet.TransFuseNet": RetinaLiteNet.TransFuseNet,
    "UNetPP.NestedUNet": UNetPP.NestedUNet,
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
        f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")


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
    """Registry names of the models that take ``logit_head``: those whose
    reference forward ends in a sigmoid that training squashes again
    (BCDUNet.py:144/251, RetinaLiteNet.py:198) or in a softmax over one
    channel (BARUNet.py:83, BIARUNet.py:89).  With it set they return the
    head before it (the train CLI's ``--logit-head``; same parameters)."""
    return sorted(name for name in MODEL_REGISTRY
                  if model_takes(name, "logit_head"))


def s2d_capable():
    """Registry names of the models that take ``s2d``, the space-to-depth
    execution of their narrow-channel blocks (``ops/s2d.py``): FRUNet,
    MultiResUNet and NestedUNet (the train and eval CLIs' ``--s2d``; same
    parameters)."""
    return sorted(name for name in MODEL_REGISTRY
                  if model_takes(name, "s2d"))


def with_kwargs(model, name: str, kwargs):
    """Model ``name`` built with ``kwargs`` and holding ``model``'s state
    dict (loaded strict), on its device, in its mode, channels_last: a
    change of execution mode (``s2d``) over the same parameters."""
    device = next(model.parameters()).device
    with torch.device(device):
        new = create_model(name, **kwargs)
    new.load_state_dict(model.state_dict(), strict=True)
    return new.to(memory_format=torch.channels_last).train(model.training)
