"""Space-to-depth execution (``s2d=True``) of the port's NestedUNet,
MultiResUNet and FRUNet against the JAX package's s2d models on the same
weights (CPU, f32, full width on 2 x 32 x 32 inputs, as the JAX package's
``tests/test_s2d.py`` runs them): the eval forward, the train forward with
its updated running statistics, the port's s2d mode against its own plain
mode (the same function over the same parameters, so one state dict loads
``strict=True`` into both), the fused-conv sites, the blocks' own s2d
forms, and FRUNet's Dropout2d masks with dropout live."""

import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu_torch.models import create_model, s2d_capable
from jcfszxc_unet_tpu_torch.ops import blocks, s2d
from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters

from .torch_port_common import (
    EVAL_TOL,
    assert_close_to,
    check_eval,
    check_train,
    jax_model,
    kernel_calls,
    port_model,
    silence_dropout,
    to_nhwc,
    to_port,
)

NAMES = ["FRUNet.FRUNet", "MultiResUNet.MultiResUNet", "UNetPP.NestedUNet"]
# The fused-conv launches of one eval forward by body: the same as the
# plain mode's (tests/test_torch_port_zoo_*.py).  In s2d mode a 3x3 runs
# as a 3x3 on 4x the channels, and FRUNet's FeatureFuse sums its three
# s2d kernels into the one launch its plain form makes for its 3x3.
S2D_SITES = {
    "FRUNet.FRUNet": {"mma_sync": 1, "wgmma": 43},
    "MultiResUNet.MultiResUNet": {"mma_sync": 25, "wgmma": 12},
    "UNetPP.NestedUNet": {"mma_sync": 1, "wgmma": 29},
}
# So the launch counts cannot tell the modes apart; the shapes do.  Per
# model, (H, W, Cin, Cout) of fused convs that only s2d mode makes on a
# 32^2 input: the first conv on the packed 3-channel input, and FRUNet's
# 32-wide row as 128 -> 128 at 16^2.
S2D_ONLY_SHAPES = {
    "FRUNet.FRUNet": [(16, 16, 12, 128), (16, 16, 128, 128)],
    "MultiResUNet.MultiResUNet": [(16, 16, 12, 32)],
    "UNetPP.NestedUNet": [(16, 16, 12, 128), (16, 16, 128, 128)],
}


@pytest.fixture(scope="module", params=NAMES)
def zoo(request):
    name = request.param
    seed = 200 + NAMES.index(name)
    jmodel, variables = jax_model(name, seed=seed, s2d=True)
    x = np.random.RandomState(seed + 10).rand(2, 32, 32, 3).astype(
        np.float32)
    return name, jmodel, variables, x


def test_s2d_capable_names_the_three_models():
    assert s2d_capable() == NAMES


def test_s2d_eval_forward_matches_jax(zoo):
    name, jmodel, variables, x = zoo
    port = port_model(name, variables, s2d=True)
    assert port.s2d
    want = check_eval(jmodel, variables, port, x)
    assert want.std() > 1e-3  # the comparison can fail


def test_s2d_train_forward_and_running_stats_match_jax(zoo, monkeypatch):
    """At 2e-4 of max |output|, the JAX package's own s2d tolerance
    (tests/test_s2d.py), running statistics at 1e-4."""
    name, jmodel, variables, x = zoo
    check_train(name, jmodel, variables, x, monkeypatch, tol=2e-4, s2d=True)


def test_s2d_mode_equals_plain_mode(zoo):
    """Same weights, both modes: eval outputs, and train outputs with
    every running statistic and batch count after one forward."""
    name, _, variables, x = zoo
    plain = port_model(name, variables)
    packed = port_model(name, variables, s2d=True)
    with torch.no_grad():
        want = to_nhwc(plain(to_port(x)))
        assert_close_to(to_nhwc(packed(to_port(x))), want, EVAL_TOL)
        for m in (plain, packed):
            silence_dropout(m.train())
        want = to_nhwc(plain(to_port(x)))
        assert_close_to(to_nhwc(packed(to_port(x))), want, 1e-4)
    sd_plain, sd_packed = plain.state_dict(), packed.state_dict()
    assert list(sd_plain) == list(sd_packed)
    for k, v in sd_plain.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(sd_packed[k]) >= 1, k
        elif "running" in k:
            np.testing.assert_allclose(sd_packed[k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_state_dict_loads_strict_into_both_modes(zoo):
    name = zoo[0]
    g = torch.Generator().manual_seed(1)
    src = create_model(name, s2d=True)
    reset_parameters(src, g)
    for s2d_mode in (False, True):
        dst = create_model(name, s2d=s2d_mode)
        dst.load_state_dict(src.state_dict(), strict=True)
        for (k, a), b in zip(src.state_dict().items(),
                             dst.state_dict().values()):
            assert torch.equal(a, b), k


def test_s2d_fused_conv_sites(zoo, monkeypatch):
    """The launches by body, and the shapes that show the convs ran in s2d
    space: a model left in plain mode fails here."""
    name, _, variables, x = zoo
    shapes, plain_shapes = {}, {}
    port = port_model(name, variables, s2d=True)
    assert kernel_calls(port, x, monkeypatch, shapes) == S2D_SITES[name]
    kernel_calls(port_model(name, variables), x, monkeypatch, plain_shapes)
    assert shapes != plain_shapes
    for key in S2D_ONLY_SHAPES[name]:
        assert key in shapes and key not in plain_shapes, key


def test_frunet_dropout_masks_match_across_modes_with_dropout_live():
    """Dropout2d live (p 0.2, train mode): from one RNG state the s2d
    model draws the plain model's masks, a (B, C) draw per FRConv dropout
    that drops an original channel's 4 phases together."""
    name = "FRUNet.FRUNet"
    g = torch.Generator().manual_seed(3)
    plain = create_model(name)
    reset_parameters(plain, g)
    packed = create_model(name, s2d=True)
    packed.load_state_dict(plain.state_dict(), strict=True)
    x = to_port(np.random.RandomState(4).rand(2, 32, 32, 3).astype(
        np.float32))
    outs = []
    for model in (plain, packed, plain):
        model.train()
        torch.manual_seed(5)
        with torch.no_grad():
            outs.append(to_nhwc(model(x)))
    silence_dropout(plain)
    with torch.no_grad():
        quiet = to_nhwc(plain(x))
    assert np.abs(outs[0] - quiet).max() > 1e-2  # the masks drop something
    np.testing.assert_array_equal(outs[0], outs[2])
    assert_close_to(outs[1], outs[0], 1e-4)


def test_dropout2d_s2d_drops_whole_original_channels():
    drop = torch.nn.Dropout2d(0.5).train()
    x = s2d.space_to_depth(torch.ones(4, 16, 6, 6).contiguous(
        memory_format=torch.channels_last))
    y = s2d.depth_to_space(blocks.dropout2d_s2d(drop, x))
    per_channel = y.amax(dim=(2, 3))
    assert torch.equal(per_channel, y.amin(dim=(2, 3)))  # all or nothing
    assert set(per_channel.unique().tolist()) == {0.0, 2.0}


@pytest.mark.parametrize("block", [
    "DoubleConvBias", "Multiresblock", "Respath"])
@pytest.mark.parametrize("train", [False, True])
def test_blocks_s2d_io_equals_plain(block, train):
    """The blocks' persistent s2d form (``s2d_io=True`` on a packed input)
    against the plain block on the same weights, eval and train mode."""
    from jcfszxc_unet_tpu_torch.models.UNetPP import DoubleConvBias

    make = {"DoubleConvBias": lambda: DoubleConvBias(6, 8),
            "Multiresblock": lambda: blocks.Multiresblock(6, 8),
            "Respath": lambda: blocks.Respath(6, 8, 3)}[block]
    plain, packed = make(), make()
    reset_parameters(plain, torch.Generator().manual_seed(7))
    packed.load_state_dict(plain.state_dict(), strict=True)
    x = to_port(np.random.RandomState(8).randn(2, 12, 10, 6).astype(
        np.float32))
    with torch.no_grad():
        for m in (plain, packed):
            m.train(train)
        want = to_nhwc(plain(x))
        got = s2d.depth_to_space(packed(s2d.space_to_depth(x), s2d_io=True))
        assert_close_to(to_nhwc(got), want, 1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_frblock_s2d_flag_equals_plain(train):
    """FRBlock's own ``s2d`` form (pack, run, unpack) against the plain
    block, eval and train mode (the dropout silenced); an odd map falls
    back to the plain form, as in the JAX block."""
    plain = blocks.FRBlock(6, 8, 0.3)
    packed = blocks.FRBlock(6, 8, 0.3, s2d=True)
    reset_parameters(plain, torch.Generator().manual_seed(7))
    packed.load_state_dict(plain.state_dict(), strict=True)
    x = to_port(np.random.RandomState(8).randn(2, 12, 10, 6).astype(
        np.float32))
    with torch.no_grad():
        for m in (plain, packed):
            silence_dropout(m.train(train))
        want = to_nhwc(plain(x))
        assert_close_to(to_nhwc(packed(x)), want, 1e-4)
        odd = x[:, :, :11, :9]
        want = to_nhwc(plain(odd))
        np.testing.assert_array_equal(to_nhwc(packed(odd)), want)
