"""The port's DenseUNet against the JAX model on the same weights (CPU,
f32, full width on 2 x 32 x 32 inputs): the weight bridge (the numbered
conv and BN lists), the eval and train-mode forwards (the dense additive
skips before each BN, the k4 s2 p1 transposed conv), the reference's
``n_classes`` defect and the fused-conv sites."""

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

NAME = "DenseUNet.DenseUNet"


@pytest.fixture(scope="module")
def zoo():
    jmodel, variables = jax_model(NAME, seed=90)
    x = np.random.RandomState(91).rand(2, 32, 32, 3).astype(np.float32)
    return jmodel, variables, port_model(NAME, variables), x


def test_dense_bridge_equals_torch_mapping(zoo):
    check_bridge(NAME, zoo[1])


def test_dense_eval_forward_matches_jax(zoo):
    check_eval(*zoo)


def test_dense_train_forward_and_running_stats_match_jax(zoo, monkeypatch):
    jmodel, variables, _, x = zoo
    check_train(NAME, jmodel, variables, x, monkeypatch)


def test_dense_fused_conv_sites_and_n_classes(zoo, monkeypatch):
    # 9 levels x 4 convs + 4 UpsampleNConcat convs, all Cin 128 or 256;
    # the Cin = 3 input goes through a 1x1 conv first
    assert kernel_calls(zoo[2], zoo[3], monkeypatch) == {"wgmma": 40}
    assert zoo[2].n_classes == zoo[0].n_classes == 128
