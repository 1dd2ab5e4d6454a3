"""Model registry of the port, with the JAX package's registry names and
constructor arguments.

Seven of the zoo's 16 models are ported; any other name raises a
``KeyError`` that says so.
"""

from __future__ import annotations

from jcfszxc_unet_tpu_torch.models import (
    AttentionUNet,
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


def create_model(name: str, **kwargs):
    """Instantiate a model from the registry by name."""
    return resolve_model(name)(**kwargs)
