"""The port's SegNet against the JAX SegNet on the same weights (CPU, f32,
full width on 2 x 32 x 32 inputs): the weight bridge, the eval and
train-mode forwards (argmax pooling and unpooling), the fused-conv sites
of its eval forward and its refusal of sizes it cannot pool."""

import numpy as np
import pytest
import torch

from .torch_port_common import (
    check_bridge,
    check_eval,
    check_train,
    jax_model,
    kernel_calls,
    port_model,
    to_port,
)

NAME = "SegNet.SegNet"


@pytest.fixture(scope="module")
def zoo():
    jmodel, variables = jax_model(NAME, seed=20)
    x = np.random.RandomState(21).rand(2, 32, 32, 3).astype(np.float32)
    return jmodel, variables, port_model(NAME, variables), x


def test_segnet_bridge_equals_torch_mapping(zoo):
    check_bridge(NAME, zoo[1])


def test_segnet_eval_forward_matches_jax(zoo):
    check_eval(*zoo)


def test_segnet_train_forward_and_running_stats_match_jax(zoo, monkeypatch):
    jmodel, variables, _, x = zoo
    check_train(NAME, jmodel, variables, x, monkeypatch)


def test_segnet_fused_conv_sites(zoo, monkeypatch):
    # 25 conv -> BN -> ReLU stages (the first from Cin = 3) and the
    # 64 -> 1 head with its bias as the shift, ReLU off (the narrow body)
    assert kernel_calls(zoo[2], zoo[3], monkeypatch) == {"mma_sync": 1,
                                                         "wgmma": 24,
                                                         "narrow": 1}


def test_segnet_refuses_sizes_it_cannot_pool(zoo):
    with pytest.raises(ValueError, match="even H and W"):
        with torch.no_grad():
            zoo[2](to_port(np.zeros((1, 48, 48, 3), np.float32)))
