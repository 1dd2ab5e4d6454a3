"""The port's BCDU_net_D3 and BCDU_net_D1 against the JAX models on the
same weights (CPU, f32, full width on 2 x 32 x 32 inputs): the weight
bridge (the transparent encoder and decoder, the ConvLSTMs' one cell conv
each), the eval and train-mode forwards (dropout silenced on both sides),
the pre-sigmoid head of ``logit_head=True`` and the fused-conv sites of
the eval forward."""

import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.models import create_model as jax_create_model

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

# Per ConvLSTM2D: one x-half call on both steps stacked on the batch and
# one h-half call (the first step's is skipped); only conv1's first conv
# reads Cin = 3.  conv1's 32 -> 64, the last ConvLSTM's 32 -> 128 h-half
# and the 64 -> 2 head take the narrow body.
SITES = {"BCDUNet.BCDU_net_D3": {"mma_sync": 1, "wgmma": 21, "narrow": 3},
         "BCDUNet.BCDU_net_D1": {"mma_sync": 1, "wgmma": 17, "narrow": 3}}


@pytest.fixture(scope="module", params=sorted(SITES))
def zoo(request):
    name = request.param
    jmodel, variables = jax_model(name, seed=70)
    x = np.random.RandomState(71).rand(2, 32, 32, 3).astype(np.float32)
    return name, jmodel, variables, port_model(name, variables), x


def test_bcdu_bridge_equals_torch_mapping(zoo):
    check_bridge(zoo[0], zoo[2])


def test_bcdu_eval_forward_matches_jax(zoo):
    check_eval(*zoo[1:])


def test_bcdu_train_forward_and_running_stats_match_jax(zoo, monkeypatch):
    name, jmodel, variables, _, x = zoo
    check_train(name, jmodel, variables, x, monkeypatch)


def test_bcdu_fused_conv_sites(zoo, monkeypatch):
    assert kernel_calls(zoo[3], zoo[4], monkeypatch) == SITES[zoo[0]]


def test_bcdu_logit_head_matches_jax_pre_sigmoid_head(zoo):
    name, _, variables, port, x = zoo
    jmodel = jax_create_model(name, logit_head=True)
    want = np.asarray(jax_apply(jmodel, variables, x, train=False))
    head = port_model(name, variables, logit_head=True)
    with torch.no_grad():
        got = head(to_port(x))
        sig = port(to_port(x))
    assert_close_to(to_nhwc(got), want, EVAL_TOL)
    # the same forward up to the head: the default is its sigmoid
    np.testing.assert_allclose(to_nhwc(torch.sigmoid(got)), to_nhwc(sig),
                               atol=1e-6)
    assert float((got - sig).abs().min()) > 1e-2  # not the sigmoid
