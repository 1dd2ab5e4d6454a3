"""The port's MultiResUNet against the JAX model on the same weights (CPU,
f32, full width on 2 x 32 x 32 inputs): the weight bridge (the Respaths'
numbered children), the eval and train-mode forwards (the Respaths' BN
applied twice per unit, so its running statistics take two updates), the
fused-conv sites at the truncated widths, and that the s2d mode builds
(its parity is tests/test_torch_port_s2d_models.py's) and UNet refuses
it."""

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

NAME = "MultiResUNet.MultiResUNet"


@pytest.fixture(scope="module")
def zoo():
    jmodel, variables = jax_model(NAME, seed=80)
    x = np.random.RandomState(81).rand(2, 32, 32, 3).astype(np.float32)
    return jmodel, variables, port_model(NAME, variables), x


def test_multires_bridge_equals_torch_mapping(zoo):
    check_bridge(NAME, zoo[1])


def test_multires_eval_forward_matches_jax(zoo):
    check_eval(*zoo)


def test_multires_train_forward_and_running_stats_match_jax(zoo,
                                                             monkeypatch):
    jmodel, variables, _, x = zoo
    check_train(NAME, jmodel, variables, x, monkeypatch)


def test_multires_fused_conv_sites(zoo, monkeypatch):
    # 9 blocks x 3 + 4 + 3 + 2 + 1 Respath units; int(F * 1.67 * k)
    # widths (8, 17, 26, 35, 53, 71, 106, 142, 213, 284, 427) off the
    # Cin % 8 == 0 bodies, with the Cin = 3 input; of those twelve, the
    # 8 -> 17, 32 -> 32, 64 -> 8 and 128 -> 17 ones take the narrow body
    assert kernel_calls(zoo[2], zoo[3], monkeypatch) == {"mma_sync": 25,
                                                         "wgmma": 5,
                                                         "narrow": 7}


def test_multires_s2d_builds_and_unet_refuses_it():
    from jcfszxc_unet_tpu_torch.models import create_model, s2d_capable

    assert create_model(NAME, s2d=True).s2d and NAME in s2d_capable()
    with pytest.raises(TypeError, match="s2d"):
        create_model("UNet.UNet", s2d=True)
