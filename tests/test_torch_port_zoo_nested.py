"""The port's NestedUNet (UNet++) against the JAX model on the same
weights (CPU, f32, full width on 2 x 32 x 32 inputs): the weight bridge,
the eval and train-mode forwards (bilinear align-corners upsampling, the
dense concats), deep supervision, the fused-conv sites, and that the s2d
mode builds (its parity is tests/test_torch_port_s2d_models.py's) and
UNet refuses it."""

import numpy as np
import pytest
import torch

from .torch_port_common import (
    EVAL_TOL,
    assert_close_to,
    check_bridge,
    check_eval,
    check_train,
    jax_apply,
    jax_model,
    kernel_calls,
    port_model,
    to_nhwc,
    to_port,
)

NAME = "UNetPP.NestedUNet"


@pytest.fixture(scope="module")
def zoo():
    jmodel, variables = jax_model(NAME, seed=30)
    x = np.random.RandomState(31).rand(2, 32, 32, 3).astype(np.float32)
    return jmodel, variables, port_model(NAME, variables), x


def test_nested_bridge_equals_torch_mapping(zoo):
    check_bridge(NAME, zoo[1])


def test_nested_eval_forward_matches_jax(zoo):
    check_eval(*zoo)


def test_nested_train_forward_and_running_stats_match_jax(zoo, monkeypatch):
    jmodel, variables, _, x = zoo
    check_train(NAME, jmodel, variables, x, monkeypatch)


def test_nested_fused_conv_sites(zoo, monkeypatch):
    # 15 nodes x 2 convs; only conv0_0's first conv reads Cin = 3; the
    # row-0 nodes' ten Cout-32 convs and conv1_0's 32 -> 64 on narrow
    assert kernel_calls(zoo[2], zoo[3], monkeypatch) == {"mma_sync": 1,
                                                         "wgmma": 19,
                                                         "narrow": 10}


def test_nested_deep_supervision_returns_the_four_heads(zoo):
    from jcfszxc_unet_tpu.models import create_model as jax_create_model

    _, variables, _, x = zoo
    rng = np.random.RandomState(32)
    params = dict(variables["params"])
    params.pop("final")
    for k in range(1, 5):
        params[f"final{k}"] = {"conv": {
            "kernel": (0.2 * rng.randn(1, 1, 32, 1)).astype(np.float32),
            "bias": (0.1 * rng.randn(1)).astype(np.float32)}}
    ds = {"params": params, "batch_stats": variables["batch_stats"]}
    jmodel = jax_create_model(NAME, deepsupervision=True)
    want = jax_apply(jmodel, ds, x, train=False)
    port = port_model(NAME, ds, deepsupervision=True)
    with torch.no_grad():
        got = port(to_port(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert_close_to(to_nhwc(g), np.asarray(w), EVAL_TOL)


def test_nested_s2d_builds_and_unet_refuses_it():
    from jcfszxc_unet_tpu_torch.models import create_model, s2d_capable

    assert create_model(NAME, s2d=True).s2d and NAME in s2d_capable()
    with pytest.raises(TypeError, match="s2d"):
        create_model("UNet.UNet", s2d=True)
