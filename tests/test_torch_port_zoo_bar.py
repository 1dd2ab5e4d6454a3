"""The port's BARUNet and BIARUNet against the JAX models on the same
weights (CPU, f32, full width on 2 x 32 x 32 inputs): the weight bridge
(BAModule's Linears and BatchNorm1ds, the CBAMs, BIARUNet's SE blocks),
the eval and train-mode forwards with their logit head (the 0.5 dropout
of each BABasicBlock's residual silenced on both sides), the reference's
softmax over one channel, the fused-conv sites of the eval forward, and
two steps of the port's train CLI."""

import numpy as np
import pytest
import torch

from .torch_port_common import (
    check_bridge,
    check_eval,
    check_train,
    check_train_cli,
    jax_apply,
    jax_model,
    kernel_calls,
    port_model,
    synthetic_train_h5,
    to_nhwc,
    to_port,
)

NAMES = ["BARUNet.BARUNet", "BIARUNet.BIARUNet"]


@pytest.fixture(scope="module", params=NAMES)
def zoo(request):
    # The plain head is a softmax over one channel, a constant 1.0: the
    # forwards are compared on the logit head (same parameters).
    name = request.param
    jmodel, variables = jax_model(name, seed=110, logit_head=True)
    x = np.random.RandomState(111).rand(2, 32, 32, 3).astype(np.float32)
    return (name, jmodel, variables,
            port_model(name, variables, logit_head=True), x)


def test_bar_bridge_equals_torch_mapping(zoo):
    check_bridge(zoo[0], zoo[2])


def test_bar_eval_forward_matches_jax(zoo):
    want = check_eval(*zoo[1:])
    assert want.std() > 1e-3  # not a constant map


def test_bar_train_forward_and_running_stats_match_jax(zoo, monkeypatch):
    name, jmodel, variables, _, x = zoo
    check_train(name, jmodel, variables, x, monkeypatch, logit_head=True)


def test_bar_fused_conv_sites(zoo, monkeypatch):
    # Conv1 2, four BABasicBlocks 2 each, Up5..2 1 each, Up_conv5..2 2 each
    assert kernel_calls(zoo[3], zoo[4], monkeypatch) == {"mma_sync": 1,
                                                         "wgmma": 21}


def test_bar_plain_head_is_the_reference_constant_softmax(zoo):
    from jcfszxc_unet_tpu.models import create_model as jax_create_model

    name, _, variables, port, x = zoo
    want = np.asarray(jax_apply(jax_create_model(name), variables, x,
                                train=False))
    port.logit_head = False  # the same parameters under the plain head
    try:
        with torch.no_grad():
            got = to_nhwc(port(to_port(x)))
    finally:
        port.logit_head = True
    assert (want == 1.0).all() and (got == 1.0).all()


@pytest.fixture(scope="module")
def train_h5(tmp_path_factory):
    return synthetic_train_h5(tmp_path_factory.mktemp("drive"))


@pytest.mark.parametrize("name", NAMES)
def test_bar_train_cli_two_steps(name, train_h5, tmp_path, monkeypatch):
    check_train_cli(name, train_h5, tmp_path, monkeypatch)
