"""The zoo's blocks and layers in the port against the JAX package's (CPU,
f32): RecurrentBlock's t+1 shared-conv applications, ResidualConv at
stride 1 and 2, the attention gate, the conv blocks, ConvLSTM2D forwards
and backwards, MultiResUNet's, DenseUNet's and FRUNet's blocks, SegNet's
argmax pooling with ties, and the nearest and bilinear (align-corners)
upsamplings.  Weights cross over through
``compat.from_jax.block_state_dict_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.ops import blocks as jax_blocks
from jcfszxc_unet_tpu.ops import layers as jax_layers
from jcfszxc_unet_tpu_torch.compat.from_jax import (
    MappingError,
    block_state_dict_from_jax,
)
from jcfszxc_unet_tpu_torch.ops import blocks, layers

from .torch_port_common import (
    EVAL_TOL,
    STATS_TOL,
    TRAIN_TOL,
    assert_close_to,
    randomize_bn,
    to_nhwc,
    to_port,
)


def _pair(cls, jax_args, port_args, inputs, seed):
    """(JAX block, numpy variables with random BN, port block loaded
    strict from them, eval mode)."""
    jmod = getattr(jax_blocks, cls)(*jax_args)
    variables = randomize_bn(
        jmod.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs),
                  train=False), seed + 1)
    port = getattr(blocks, cls)(*port_args)
    port.load_state_dict(block_state_dict_from_jax(cls, variables),
                         strict=True)
    return jmod, variables, port.to(memory_format=torch.channels_last).eval()


def _assert_outputs_close(got, want, tol):
    """One output or a tuple of them (FRBlock's branches)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close_to(to_nhwc(g), w, tol)


def _check_both_modes(cls, jmod, variables, port, inputs, monkeypatch):
    """Eval output, then one train-mode forward's output and running
    statistics, against the JAX block (two-pass batch variance)."""
    xs = [jnp.asarray(a) for a in inputs]
    with torch.no_grad():
        got = port(*map(to_port, inputs))
    _assert_outputs_close(got, jmod.apply(variables, *xs, train=False),
                          EVAL_TOL)
    monkeypatch.setattr(jax_layers, "TRAIN_BN_ONE_PASS_STATS", False)
    want, upd = jmod.apply(variables, *xs, train=True,
                           mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        got = port(*map(to_port, inputs))
    _assert_outputs_close(got, want, TRAIN_TOL)
    new = block_state_dict_from_jax(cls, {
        "params": variables["params"],
        "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    sd = port.state_dict()
    for k, v in new.items():
        if k.endswith(("running_mean", "running_var")):
            assert_close_to(sd[k].numpy(), v.numpy(), STATS_TOL)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("t", [0, 2])
def test_recurrent_block_applies_its_conv_t_plus_1_times(t, monkeypatch):
    x = _x(2, 8, 8, 16, seed=t)
    jmod, variables, port = _pair("RecurrentBlock", (16, t), (16, t), [x], 3)
    # eval mode: one fold for the block, t + 1 kernel calls
    calls = {"fold": 0, "conv": 0}
    real_fold, real_conv = blocks.fold, blocks.conv3x3_affine_relu_kmajor

    def fold(*a, **k):
        calls["fold"] += 1
        return real_fold(*a, **k)

    def conv(*a, **k):
        calls["conv"] += 1
        return real_conv(*a, **k)

    monkeypatch.setattr(blocks, "fold", fold)
    monkeypatch.setattr(blocks, "conv3x3_affine_relu_kmajor", conv)
    with torch.no_grad():
        port(to_port(x))
    assert calls == {"fold": 1, "conv": t + 1}
    monkeypatch.undo()
    # train mode: the shared BN's running stats take t + 1 updates
    before = port.conv[1].running_mean.clone()
    _check_both_modes("RecurrentBlock", jmod, variables, port, [x],
                      monkeypatch)
    assert int(port.conv[1].num_batches_tracked) == t + 1
    assert not torch.equal(before, port.conv[1].running_mean)


@pytest.mark.parametrize("stride", [1, 2])
def test_residual_conv_matches_jax(stride, monkeypatch):
    x = _x(2, 8, 8, 16, seed=stride)
    jmod, variables, port = _pair("ResidualConv", (16, 32, stride, 1),
                                  (16, 32, stride, 1), [x], 5)
    _check_both_modes("ResidualConv", jmod, variables, port, [x],
                      monkeypatch)


@pytest.mark.parametrize("cls,args,shapes", [
    ("AttentionBlock", (16, 8, 4), [(2, 8, 8, 16), (2, 8, 8, 8)]),
    ("ConvBlockBN", (8, 16), [(2, 8, 6, 8)]),
    ("UpConvBlock", (16, 8), [(2, 4, 5, 16)]),
    ("RRCNNBlock", (3, 8, 2), [(2, 6, 6, 3)]),
    # int(16 * 1.67 * k) widths 4, 8, 13; two units of one BN applied twice
    ("Multiresblock", (8, 16), [(2, 8, 8, 8)]),
    ("Respath", (12, 16, 2), [(2, 8, 8, 12)]),
    ("SingleLevelDensenet", (16, 4), [(2, 8, 8, 16)]),
    ("UpsampleNConcat", (16,), [(2, 4, 5, 16), (2, 8, 10, 16)]),
    ("UpConvT", (16, 8), [(2, 4, 5, 16)]),
])
def test_zoo_blocks_match_jax(cls, args, shapes, monkeypatch):
    inputs = [_x(*s, seed=i) for i, s in enumerate(shapes)]
    jmod, variables, port = _pair(cls, args, args, inputs, 7)
    _check_both_modes(cls, jmod, variables, port, inputs, monkeypatch)


@pytest.mark.parametrize("in_c,is_up,is_down", [
    (8, False, False), (8, True, True), (8, True, False),
    (16, False, True),  # in_c == out_c: no fuse
])
def test_fr_block_matches_jax(in_c, is_up, is_down, monkeypatch):
    x = _x(2, 8, 6, in_c, seed=in_c)
    args = (in_c, 16, 0.0, is_up, is_down)
    jmod, variables, port = _pair("FRBlock", args, args, [x], 13)
    assert (port.fuse is None) == (in_c == 16)
    _check_both_modes("FRBlock", jmod, variables, port, [x], monkeypatch)


@pytest.mark.parametrize("go_backwards", [False, True])
def test_conv_lstm_matches_jax_in_both_directions(go_backwards, monkeypatch):
    x = _x(2, 3, 6, 5, 8, seed=11)  # (B, T, H, W, C)
    jmod = jax_blocks.ConvLSTM2D(8, 4, go_backwards=go_backwards)
    variables = jax.tree.map(np.asarray,
                             jmod.init(jax.random.PRNGKey(12), jnp.asarray(x)))
    want = jmod.apply(variables, jnp.asarray(x))
    port = blocks.ConvLSTM2D(8, 4, go_backwards=go_backwards)
    port.load_state_dict(block_state_dict_from_jax("ConvLSTM2D", variables),
                         strict=True)
    steps = [to_port(x[:, t]) for t in range(x.shape[1])]
    batches = []
    real = blocks.conv3x3_affine_relu_kmajor

    def conv(xh, *a, **k):
        batches.append(xh.shape[0])
        return real(xh, *a, **k)

    monkeypatch.setattr(blocks, "conv3x3_affine_relu_kmajor", conv)
    with torch.no_grad():
        got = port.eval()(*steps)
        # the x-half of all 3 steps in one call, then the h-half of steps
        # 2 and 3 (the first one's h is zero)
        assert batches == [6, 2, 2]
        assert_close_to(to_nhwc(got), want, EVAL_TOL)
        got = port.train()(*steps)
    assert batches == [6, 2, 2]  # train mode: stock convs only
    assert_close_to(to_nhwc(got), want, EVAL_TOL)


def test_block_bridge_refuses_unknown_blocks():
    with pytest.raises(MappingError, match="no mapping rules"):
        block_state_dict_from_jax("NoSuchBlock", {"params": {}})


def _tied():
    """(2, 6, 4, 3) NHWC values on a 1/4 grid with ties inside pooling
    windows: one window all equal, others with two equal maxima along a
    row, a column and a diagonal."""
    x = np.round(4 * _x(2, 6, 4, 3, seed=9)) / 4
    x[0, 0:2, 0:2, 0] = 1.5                 # four-way tie
    x[0, 2, 2:4, 1] = 2.0                   # tie along the top row
    x[1, 4:6, 0, 2] = 3.0                   # tie down the left column
    x[1, 4, 3, 2], x[1, 5, 2, 2] = 7.0, 7.0  # diagonal tie
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pooling_ties_go_to_the_first_maximum(dtype):
    x = _tied()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want_p, want_oh = jax_layers.max_pool2d_with_indices(
        jnp.asarray(x, jdt))
    got_p, got_oh = layers.max_pool2d_with_indices(to_port(x).to(dtype))
    np.testing.assert_array_equal(to_nhwc(got_p.float()),
                                  np.asarray(want_p, np.float32))
    np.testing.assert_array_equal(got_oh.float().numpy(),
                                  np.asarray(want_oh, np.float32))
    assert got_oh.float().sum(dim=3).eq(1).all()  # one position per window
    assert got_oh[0, 0, 0, :, 0].tolist() == [1, 0, 0, 0]
    assert got_oh[1, 2, 1, :, 2].tolist() == [0, 1, 0, 0]  # the first 7.0
    up = layers.max_unpool2d(got_p, got_oh)
    want_up = jax_layers.max_unpool2d(want_p, want_oh)
    np.testing.assert_array_equal(to_nhwc(up.float()),
                                  np.asarray(want_up, np.float32))
    assert up.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("hw", [(5, 7), (16, 16)])
@pytest.mark.parametrize("matmul_form", [True, False])
def test_bilinear_align_corners_matches_jax(hw, matmul_form, monkeypatch):
    monkeypatch.setattr(jax_layers, "BILINEAR_VIA_MATMUL", matmul_form)
    x = _x(2, *hw, 3, seed=hw[0])
    want = jax_layers.upsample_bilinear(jnp.asarray(x), 2, align_corners=True)
    got = layers.upsample_bilinear(to_port(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-6)


def test_nearest_upsample_matches_jax():
    x = _x(2, 3, 5, 4, seed=1)
    got = layers.upsample_nearest(to_port(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(
        to_nhwc(got), np.asarray(jax_layers.upsample_nearest(jnp.asarray(x))))
