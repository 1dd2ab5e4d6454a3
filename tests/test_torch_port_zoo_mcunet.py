"""The port's MCUNet against the JAX model on the same weights (CPU, f32,
full width on 2 x 32 x 32 inputs): the weight bridge (the CBAMs, the
InceptionA bottleneck's BasicConv2ds, the UpV1 decoder), the eval and
train-mode forwards (InceptionA's BatchNorms at eps 1e-3, ``up1``'s center
crop), the fused-conv sites of the eval forward and two steps of the
port's train CLI."""

import numpy as np
import pytest

from .torch_port_common import (
    check_bridge,
    check_eval,
    check_train,
    check_train_cli,
    jax_model,
    kernel_calls,
    port_model,
    synthetic_train_h5,
)

NAME = "MCUNet.MCUNet"


@pytest.fixture(scope="module")
def zoo():
    jmodel, variables = jax_model(NAME, seed=120)
    x = np.random.RandomState(121).rand(2, 32, 32, 3).astype(np.float32)
    return jmodel, variables, port_model(NAME, variables), x


def test_mcunet_bridge_equals_torch_mapping(zoo):
    check_bridge(NAME, zoo[1])


def test_mcunet_eval_forward_matches_jax(zoo):
    check_eval(*zoo)


def test_mcunet_train_forward_and_running_stats_match_jax(zoo, monkeypatch):
    jmodel, variables, _, x = zoo
    check_train(NAME, jmodel, variables, x, monkeypatch)


def test_mcunet_fused_conv_sites(zoo, monkeypatch):
    # in_conv 2, down1..3 2 each, InceptionA's three 3x3s, up1..4 2 each;
    # the seven with Cin <= 32 or Cout <= 32 on the narrow body
    assert kernel_calls(zoo[2], zoo[3], monkeypatch) == {"mma_sync": 1,
                                                         "wgmma": 11,
                                                         "narrow": 7}


def test_mcunet_inception_folds_its_own_eps(zoo):
    port = zoo[2]
    bns = [m.bn for m in port.down4.modules()
           if type(m).__name__ == "BasicConv2d"]
    assert len(bns) == 7 and all(bn.eps == 1e-3 for bn in bns)
    assert port.in_conv.double_conv[1].eps == 1e-5


def test_mcunet_train_cli_two_steps(tmp_path_factory, tmp_path, monkeypatch):
    train_h5 = synthetic_train_h5(tmp_path_factory.mktemp("drive"))
    check_train_cli(NAME, train_h5, tmp_path, monkeypatch)
