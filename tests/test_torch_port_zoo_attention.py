"""The port's AttentionUNet against the JAX model on the same weights
(CPU, f32, full width on 2 x 32 x 32 inputs): the weight bridge, the eval
and train-mode forwards (attention gates, nearest-upsample decoder) and
the fused-conv sites of its eval forward."""

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

NAME = "AttentionUNet.AttentionUNet"


@pytest.fixture(scope="module")
def zoo():
    jmodel, variables = jax_model(NAME, seed=40)
    x = np.random.RandomState(41).rand(2, 32, 32, 3).astype(np.float32)
    return jmodel, variables, port_model(NAME, variables), x


def test_attention_bridge_equals_torch_mapping(zoo):
    check_bridge(NAME, zoo[1])


def test_attention_eval_forward_matches_jax(zoo):
    check_eval(*zoo)


def test_attention_train_forward_and_running_stats_match_jax(zoo,
                                                             monkeypatch):
    jmodel, variables, _, x = zoo
    check_train(NAME, jmodel, variables, x, monkeypatch)


def test_attention_fused_conv_sites(zoo, monkeypatch):
    # 9 ConvBlockBNs x 2 and 4 UpConvBlocks; Conv1's first conv has Cin 3
    assert kernel_calls(zoo[2], zoo[3], monkeypatch) == {"mma_sync": 1,
                                                         "wgmma": 21}
