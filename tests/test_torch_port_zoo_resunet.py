"""The port's ResUNet against the JAX ResUNet on the same weights (CPU,
f32, full width on 2 x 32 x 32 inputs): the weight bridge, the eval and
train-mode forwards, and the fused-conv sites of its eval forward."""

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

NAME = "ResUNet.ResUNet"


@pytest.fixture(scope="module")
def zoo():
    jmodel, variables = jax_model(NAME, seed=10)
    x = np.random.RandomState(11).rand(2, 32, 32, 3).astype(np.float32)
    return jmodel, variables, port_model(NAME, variables), x


def test_resunet_bridge_equals_torch_mapping(zoo):
    check_bridge(NAME, zoo[1])


def test_resunet_eval_forward_matches_jax(zoo):
    want = check_eval(*zoo)
    # the model's own sigmoid: probabilities, squashed again downstream
    assert 0.0 < want.min() and want.max() < 1.0


def test_resunet_train_forward_and_running_stats_match_jax(zoo, monkeypatch):
    jmodel, variables, _, x = zoo
    check_train(NAME, jmodel, variables, x, monkeypatch)


def test_resunet_fused_conv_sites(zoo, monkeypatch):
    # 15 stride-1 3x3 convs: the stem's two Cin = 3 convs (mma_sync), its
    # second conv, conv_block.5 of all six ResidualConvs and, at stride 1,
    # their conv_block.2 and conv_skip.0; the three stride-2 convs stay
    # stock
    assert kernel_calls(zoo[2], zoo[3], monkeypatch) == {"mma_sync": 2,
                                                         "wgmma": 13}
