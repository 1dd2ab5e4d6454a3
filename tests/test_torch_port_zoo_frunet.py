"""The port's FRUNet against the JAX model on the same weights (CPU, f32,
full width on 2 x 32 x 32 inputs): the weight bridge (no dead ``fuse``
keys: it loads strict), the eval and train-mode forwards (Dropout2d
silenced on both sides, LeakyReLU, the five averaged heads), the
fused-conv sites, and that the s2d mode builds (its parity is
tests/test_torch_port_s2d_models.py's) and UNet refuses it."""

import numpy as np
import pytest

from .torch_port_common import (
    check_bridge,
    check_eval,
    check_train,
    jax_model,
    kernel_calls,
    port_model,
)

NAME = "FRUNet.FRUNet"


@pytest.fixture(scope="module")
def zoo():
    jmodel, variables = jax_model(NAME, seed=100)
    x = np.random.RandomState(101).rand(2, 32, 32, 3).astype(np.float32)
    return jmodel, variables, port_model(NAME, variables), x


def test_frunet_bridge_equals_torch_mapping(zoo):
    check_bridge(NAME, zoo[1])


def test_frunet_eval_forward_matches_jax(zoo):
    check_eval(*zoo)


def test_frunet_train_forward_and_running_stats_match_jax(zoo, monkeypatch):
    jmodel, variables, _, x = zoo
    check_train(NAME, jmodel, variables, x, monkeypatch)


def test_frunet_fused_conv_sites(zoo, monkeypatch):
    # 16 nodes x 2 FRConv convs + 12 FeatureFuse 3x3s; block1_3's fuse
    # reads Cin = 3; the 32-wide row's 14 32 -> 32 and 5 64 -> 32 convs
    # take the narrow body
    assert kernel_calls(zoo[2], zoo[3], monkeypatch) == {"mma_sync": 1,
                                                         "wgmma": 24,
                                                         "narrow": 19}


def test_frunet_s2d_builds_and_unet_refuses_it():
    from jcfszxc_unet_tpu_torch.models import create_model, s2d_capable

    assert create_model(NAME, s2d=True).s2d and NAME in s2d_capable()
    with pytest.raises(TypeError, match="s2d"):
        create_model("UNet.UNet", s2d=True)
