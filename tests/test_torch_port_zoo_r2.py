"""The port's R2UNet and R2AttentionUNet (t = 2) against the JAX models on
the same weights (CPU, f32, full width on 2 x 32 x 32 inputs): the weight
bridge, the eval and train-mode forwards (RecurrentBlock's t+1 shared
conv applications) and the fused-conv sites of the eval forward."""

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

NAMES = ["R2UNet.R2UNet", "R2AttentionUNet.R2AttentionUNet"]


@pytest.fixture(scope="module", params=NAMES)
def zoo(request):
    name = request.param
    jmodel, variables = jax_model(name, seed=50)
    x = np.random.RandomState(51).rand(2, 32, 32, 3).astype(np.float32)
    return name, jmodel, variables, port_model(name, variables), x


def test_r2_bridge_equals_torch_mapping(zoo):
    check_bridge(zoo[0], zoo[2])


def test_r2_eval_forward_matches_jax(zoo):
    check_eval(*zoo[1:])


def test_r2_train_forward_and_running_stats_match_jax(zoo, monkeypatch):
    name, jmodel, variables, _, x = zoo
    check_train(name, jmodel, variables, x, monkeypatch)


def test_r2_fused_conv_sites(zoo, monkeypatch):
    # 9 RRCNN blocks x 2 RecurrentBlocks x (t + 1) = 54, + 4 UpConvBlocks;
    # the Cin = 3 input goes through a 1x1 conv first
    assert kernel_calls(zoo[3], zoo[4], monkeypatch) == {"wgmma": 58}
