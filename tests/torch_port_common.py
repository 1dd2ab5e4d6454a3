"""Shared set-up of the PyTorch-port tests: a JAX UNet with random weights
and random BatchNorm statistics, drawn with numpy from a seed, and its
weights carried into the port."""

import jax
import jax.numpy as jnp
import numpy as np

from jcfszxc_unet_tpu.models import create_model as jax_create_model
from jcfszxc_unet_tpu_torch.compat.from_jax import state_dict_from_jax
from jcfszxc_unet_tpu_torch.models import create_model


def randomize_bn(variables, seed):
    """Random gamma/beta and running mean/var for every BatchNorm of a JAX
    variables tree (numpy, from ``seed``); returns a new tree of numpy
    arrays."""
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(np.asarray, variables)

    def walk(params, stats):
        for k, v in params.items():
            if k == "bn":
                c = v["scale"].shape[0]
                v["scale"] = (0.5 + rng.rand(c)).astype(np.float32)
                v["bias"] = (0.1 * rng.randn(c)).astype(np.float32)
                stats[k]["mean"] = (0.2 * rng.randn(c)).astype(np.float32)
                stats[k]["var"] = (0.5 + rng.rand(c)).astype(np.float32)
            elif isinstance(v, dict):
                walk(v, stats.get(k, {}))

    walk(tree["params"], tree["batch_stats"])
    return tree


def jax_unet(seed=0, hw=32):
    """(JAX UNet module, numpy variables) with random BN statistics."""
    model = jax_create_model("UNet.UNet")
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, hw, hw, 3), jnp.float32), train=False)
    return model, randomize_bn(variables, seed + 1)


def port_unet(variables):
    """The port's UNet, eval mode, channels_last, with ``variables``."""
    import torch

    model = create_model("UNet.UNet")
    model.load_state_dict(state_dict_from_jax("UNet.UNet", variables),
                          strict=True)
    return model.to(memory_format=torch.channels_last).eval()
