"""The port's TransFuseNet (RetinaLiteNet) against the JAX model on the
same weights (CPU, f32, full width on 2 x 32 x 32 inputs): the weight
bridge (the self-attention's projections, the private CBAMs, the unused
``output_OD`` head), the eval and train-mode forwards on the logit head,
the sigmoid of the default head, the fused-conv sites of the eval
forward, and two steps of the port's train CLI."""

import numpy as np
import pytest
import torch

from .torch_port_common import (
    EVAL_TOL,
    assert_close_to,
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

NAME = "RetinaLiteNet.TransFuseNet"


@pytest.fixture(scope="module")
def zoo():
    # Its decoder has no BatchNorm, so the sigmoid output is nearly
    # constant; the forwards are compared on the logit head.
    jmodel, variables = jax_model(NAME, seed=130, logit_head=True)
    x = np.random.RandomState(131).rand(2, 32, 32, 3).astype(np.float32)
    return jmodel, variables, port_model(NAME, variables, logit_head=True), x


def test_transfuse_bridge_equals_torch_mapping(zoo):
    check_bridge(NAME, zoo[1])
    sd = zoo[2].state_dict()
    assert sd["multihead_attention.mha.in_proj_weight"].shape == (96, 32)
    assert "output_OD.weight" in sd and "cbam1.spatial_att.conv.bias" not in sd


def test_transfuse_eval_forward_matches_jax(zoo):
    want = check_eval(*zoo)
    assert want.std() > 1e-3  # not a constant map


def test_transfuse_train_forward_and_running_stats_match_jax(zoo,
                                                             monkeypatch):
    jmodel, variables, _, x = zoo
    check_train(NAME, jmodel, variables, x, monkeypatch, logit_head=True)


def test_transfuse_fused_conv_sites(zoo, monkeypatch):
    # conv_block1..3 (3 -> 8 on mma_sync), decoder_conv1 48 -> 32,
    # decoder_conv2 24 -> 16 and decoder_block3's 8 -> 8, all five of
    # them on the narrow body
    assert kernel_calls(zoo[2], zoo[3], monkeypatch) == {"mma_sync": 1,
                                                         "narrow": 5}


def test_transfuse_default_head_is_the_sigmoid(zoo):
    from jcfszxc_unet_tpu.models import create_model as jax_create_model

    _, variables, port, x = zoo
    want = np.asarray(jax_apply(jax_create_model(NAME), variables, x,
                                train=False))
    with torch.no_grad():
        logits = port(to_port(x))
        port.logit_head = False  # the same parameters under the sigmoid
        try:
            got = port(to_port(x))
        finally:
            port.logit_head = True
    assert_close_to(to_nhwc(got), want, EVAL_TOL)
    np.testing.assert_allclose(to_nhwc(torch.sigmoid(logits)), to_nhwc(got),
                               atol=1e-6)


def test_transfuse_train_cli_two_steps(tmp_path_factory, tmp_path,
                                       monkeypatch):
    train_h5 = synthetic_train_h5(tmp_path_factory.mktemp("drive"))
    check_train_cli(NAME, train_h5, tmp_path, monkeypatch)
