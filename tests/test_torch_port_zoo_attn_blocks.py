"""The attention family's blocks and layers in the port against the JAX
package's (CPU, f32): BAModule's fusion of two pooled inputs (its
BatchNorm1ds in both modes), BABasicBlock, the shared
CBAM (spatial conv with a bias) and RetinaLiteNet's private one (without),
the SE block, InceptionA (BatchNorm eps 1e-3), UpV1's crop,
``avg_pool2d`` on odd maps, the self-attention at 256 tokens, the
BatchNorm1d, Linear and attention draws of ``reset_parameters`` and the
models that take ``logit_head``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.models import RetinaLiteNet as jax_retina
from jcfszxc_unet_tpu.ops import blocks as jax_blocks
from jcfszxc_unet_tpu.ops import layers as jax_layers
from jcfszxc_unet_tpu_torch.compat.from_jax import block_state_dict_from_jax
from jcfszxc_unet_tpu_torch.models import RetinaLiteNet
from jcfszxc_unet_tpu_torch.ops import blocks, layers

from .test_torch_port_zoo_blocks import _check_both_modes, _x
from .torch_port_common import (
    EVAL_TOL,
    STATS_TOL,
    TRAIN_TOL,
    assert_close_to,
    randomize_bn,
    to_nhwc,
    to_port,
)


def _pair(jmod, port, bridge_name, inputs, seed):
    """(numpy variables of ``jmod`` with random BN, ``port`` loaded strict
    from them, eval mode)."""
    variables = randomize_bn(
        jmod.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs),
                  train=False), seed + 1)
    port.load_state_dict(block_state_dict_from_jax(bridge_name, variables),
                         strict=True)
    return variables, port.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("cls,jax_mod,port_mod,shape", [
    ("CBAM", jax_blocks.CBAM(32), blocks.CBAM(32), (2, 8, 6, 32)),
    ("PrivateCBAM", jax_retina._PrivateCBAM(32),
     RetinaLiteNet._PrivateCBAM(32), (2, 8, 6, 32)),
    ("SEBlock", jax_blocks.SEBlock(64), blocks.SEBlock(64), (2, 5, 7, 64)),
])
def test_attention_gates_match_jax(cls, jax_mod, port_mod, shape):
    """Gates without a BatchNorm: one function in both modes."""
    x = _x(*shape, seed=len(cls))
    variables = jax.tree.map(np.asarray, jax_mod.init(jax.random.PRNGKey(20),
                                                      jnp.asarray(x)))
    port_mod.load_state_dict(block_state_dict_from_jax(cls, variables),
                             strict=True)
    want = jax_mod.apply(variables, jnp.asarray(x))
    for mode in (False, True):
        with torch.no_grad():
            got = port_mod.train(mode)(to_port(x))
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert_close_to(to_nhwc(got), want, EVAL_TOL)


def test_inception_a_matches_jax(monkeypatch):
    x = _x(2, 7, 5, 16, seed=21)
    jmod = jax_blocks.InceptionA(16)
    variables, port = _pair(jmod, blocks.InceptionA(16), "InceptionA", [x],
                            22)
    assert [m.bn.eps for m in port.children()] == [1e-3] * 7
    _check_both_modes("InceptionA", jmod, variables, port, [x], monkeypatch)


def test_cbam_spatial_conv_bias_follows_the_variant():
    assert blocks.CBAM(32).spatial_attention.conv2d.bias is not None
    assert RetinaLiteNet._PrivateCBAM(32).spatial_att.conv.bias is None


def test_ba_basic_block_matches_jax(monkeypatch):
    x = _x(2, 8, 8, 32, seed=1)
    jmod = jax_blocks.BABasicBlock(32, 64, 1)
    variables, port = _pair(jmod, blocks.BABasicBlock(32, 64),
                            "BABasicBlock", [x], 22)
    # the 0.5 dropout on the residual cannot match across frameworks
    port.dropout.p = 0.0
    with jax_layers.dropout_disabled():
        _check_both_modes("BABasicBlock", jmod, variables, port, [x],
                          monkeypatch)


def test_ba_module_fuses_two_pooled_inputs(monkeypatch):
    pre = [_x(4, 1, 1, 32, seed=1), _x(4, 1, 1, 48, seed=2)]
    cur = _x(4, 1, 1, 64, seed=3)
    jmod = jax_blocks.BAModule((32, 48), 64, 16)
    variables = randomize_bn(
        jmod.init(jax.random.PRNGKey(4), [jnp.asarray(p) for p in pre],
                  jnp.asarray(cur), train=False), 5)
    port = blocks.BAModule((32, 48), 64)
    sd = block_state_dict_from_jax("BAModule", variables)
    assert sorted(sd)[:3] == ["cur_fusion.0.weight", "cur_fusion.1.bias",
                              "cur_fusion.1.num_batches_tracked"]
    assert sd["generation.1.weight"].shape == (64, 4)
    assert sd["pre_fusions.1.0.weight"].shape == (4, 48)
    port.load_state_dict(sd, strict=True)
    args = ([jnp.asarray(p) for p in pre], jnp.asarray(cur))
    pre_t, cur_t = [to_port(p) for p in pre], to_port(cur)
    with torch.no_grad():
        got = port.eval()(pre_t, cur_t)
    assert got.shape == (4, 64, 1, 1)
    assert_close_to(to_nhwc(got), jmod.apply(variables, *args, train=False),
                    EVAL_TOL)
    monkeypatch.setattr(jax_layers, "TRAIN_BN_ONE_PASS_STATS", False)
    want, upd = jmod.apply(variables, *args, train=True,
                           mutable=["batch_stats"])
    with torch.no_grad():
        got = port.train()(pre_t, cur_t)
    assert_close_to(to_nhwc(got), want, TRAIN_TOL)
    new = block_state_dict_from_jax("BAModule", {
        "params": variables["params"],
        "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    stats = [k for k in new if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 6
    for k in stats:
        assert_close_to(port.state_dict()[k].numpy(), new[k].numpy(),
                        STATS_TOL)


def test_up_v1_crops_behind_a_resolution_keeping_bottleneck(monkeypatch):
    # x1 at the skip's size: the bilinear x2 overshoots, the pad crops
    x1, x2 = _x(2, 4, 6, 32, seed=6), _x(2, 4, 6, 16, seed=7)
    jmod = jax_blocks.UpV1(48, 8)
    variables, port = _pair(jmod, blocks.UpV1(48, 8), "UpV1", [x1, x2], 24)
    with torch.no_grad():
        got = port(to_port(x1), to_port(x2))
    assert got.shape == (2, 8, 4, 6)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _check_both_modes("UpV1", jmod, variables, port, [x1, x2], monkeypatch)


@pytest.mark.parametrize("kernel,stride,padding", [(3, 1, 1), (3, 2, 1),
                                                   (2, 2, 0)])
def test_avg_pool2d_counts_the_padding_on_odd_maps(kernel, stride, padding):
    x = _x(2, 7, 5, 3, seed=kernel + stride)
    want = jax_layers.avg_pool2d(jnp.asarray(x), kernel, stride, padding)
    got = layers.avg_pool2d(to_port(x), kernel, stride, padding)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-6)


def test_self_attention_matches_jax_at_256_tokens():
    x = _x(2, 256, 32, seed=8)
    jmod = jax_blocks.MultiHeadSelfAttention(32, 4)
    variables = jax.tree.map(np.asarray,
                             jmod.init(jax.random.PRNGKey(9), jnp.asarray(x)))
    # give the zero-initialised biases values, so the bridge carries them
    rng = np.random.RandomState(10)
    for proj in ("in_proj", "out_proj"):
        b = variables["params"][proj]["bias"]
        variables["params"][proj]["bias"] = (
            0.1 * rng.randn(*b.shape)).astype(np.float32)
    port = blocks.MultiHeadSelfAttention(32, 4)
    port.load_state_dict(
        block_state_dict_from_jax("MultiHeadSelfAttention", variables),
        strict=True)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        # the same function as torch's own module on these weights
        ref, _ = port.mha(*(torch.from_numpy(x),) * 3, need_weights=False)
    assert_close_to(got.numpy(), want, EVAL_TOL)
    assert_close_to(ref.numpy(), want, EVAL_TOL)


def test_reset_parameters_draws_linears_norms_and_attention_from_the_seed():
    def draw(seed, global_seed):
        torch.manual_seed(global_seed)  # must not matter
        m = torch.nn.Sequential(blocks.BAModule((32,), 64),
                                blocks.MultiHeadSelfAttention(32, 4))
        layers.reset_parameters(m, torch.Generator().manual_seed(seed))
        return m.state_dict()

    a, b = draw(0, 1), draw(0, 2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["0.cur_fusion.0.weight"],
                           draw(1, 1)["0.cur_fusion.0.weight"])
    # kaiming-uniform with a = sqrt(5): bound 1/sqrt(fan_in), fan_in 64
    assert float(a["0.cur_fusion.0.weight"].abs().max()) <= 1 / 8
    assert torch.equal(a["0.cur_fusion.1.running_var"], torch.ones(4))
    w = a["1.mha.in_proj_weight"]
    assert float(w.abs().max()) <= np.sqrt(6 / (32 + 96))  # xavier
    assert not a["1.mha.in_proj_bias"].any()
    assert not a["1.mha.out_proj.bias"].any()
    assert a["1.mha.out_proj.weight"].any()


def test_logit_head_capable_equals_jax():
    from jcfszxc_unet_tpu.models import (
        logit_head_capable as jax_logit_head_capable,
    )
    from jcfszxc_unet_tpu_torch.models import logit_head_capable

    assert logit_head_capable() == jax_logit_head_capable()
    assert len(logit_head_capable()) == 5
