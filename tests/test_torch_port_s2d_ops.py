"""The port's space-to-depth ops (``jcfszxc_unet_tpu_torch/ops/s2d.py``) and
the s2d application of its Conv2d and BatchNorm2d against the JAX
package's ``ops/s2d.py`` on the same seeded numpy inputs (CPU, f32), at
1e-5, the tolerance of the JAX package's own ``tests/test_s2d.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.ops import s2d as jax_s2d
from jcfszxc_unet_tpu.ops.layers import upsample_bilinear as jax_upsample
from jcfszxc_unet_tpu_torch.ops import s2d
from jcfszxc_unet_tpu_torch.ops.layers import BatchNorm2d, Conv2d

from .torch_port_common import to_nhwc, to_port

TOL = 1e-5


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_space_to_depth_and_back_match_jax():
    x = _rand(0, 2, 6, 8, 5)
    got = s2d.space_to_depth(to_port(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(to_nhwc(got),
                                  np.asarray(jax_s2d.space_to_depth(x)))
    back = s2d.depth_to_space(got)
    assert back.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(to_nhwc(back), x)
    with pytest.raises(ValueError, match="even H, W"):
        s2d.space_to_depth(torch.zeros(1, 2, 3, 4))


def test_selector_equals_jax():
    for k, dil in ((1, 1), (3, 1), (3, 2), (5, 1)):
        np.testing.assert_array_equal(s2d._selector(k, dil),
                                      jax_s2d._selector(k, dil))
    with pytest.raises(ValueError, match="odd kernel"):
        s2d._selector(2)


@pytest.mark.parametrize("k,dil,kk", [(1, 1, 1), (3, 1, 3), (5, 1, 3),
                                      (3, 2, 3)])
def test_s2d_kernel_matches_jax(k, dil, kk):
    w = _rand(k + dil, 6, 4, k, k, scale=0.3)      # OIHW
    got = s2d.s2d_kernel(torch.from_numpy(w), dil)
    assert tuple(got.shape) == (24, 16, kk, kk)
    want = jax_s2d.s2d_kernel(np.transpose(w, (2, 3, 1, 0)), dil)
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("k,dil", [(1, 1), (3, 1), (5, 1), (3, 2)])
def test_conv_s2d_matches_jax_and_the_plain_conv(k, dil):
    x = _rand(10 + k, 2, 8, 10, 5)
    w = _rand(20 + k, 7, 5, k, k, scale=0.3)
    bias = _rand(30 + k, 7)
    conv = Conv2d(5, 7, k, padding=k // 2 * dil, dilation=dil)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        conv.bias.copy_(torch.from_numpy(bias))
        got = conv.s2d(s2d.space_to_depth(to_port(x)))
        plain = conv(to_port(x))
    xs = jax_s2d.space_to_depth(jnp.asarray(x))
    want = (jax_s2d.conv_s2d(xs, jax_s2d.s2d_kernel(
        jnp.asarray(np.transpose(w, (2, 3, 1, 0))), dil))
        + jax_s2d.expand_vector(jnp.asarray(bias)))
    _close(to_nhwc(got), want)
    _close(to_nhwc(s2d.depth_to_space(got)), to_nhwc(plain))


def test_conv_s2d_takes_parts_and_refuses_what_has_no_s2d_form():
    a, b = _rand(1, 2, 4, 6, 3), _rand(2, 2, 4, 6, 2)
    conv = Conv2d(5, 4, 3, padding=1)
    with torch.no_grad():
        parts = conv.s2d([s2d.space_to_depth(to_port(a)),
                          s2d.space_to_depth(to_port(b))])
        whole = conv.s2d(s2d.space_to_depth(
            to_port(np.concatenate([a, b], axis=-1))))
    np.testing.assert_array_equal(parts.numpy(), whole.numpy())
    for bad in (Conv2d(4, 4, 2, stride=2), Conv2d(4, 4, 3, padding=0),
                Conv2d(4, 4, 3, padding=3, dilation=3)):
        with pytest.raises(ValueError, match="s2d conv"):
            bad.s2d(torch.zeros(1, 16, 2, 2))


def test_conv_s2d_gradient_reaches_the_original_weight():
    x = to_port(_rand(3, 1, 4, 4, 2))
    w = torch.from_numpy(_rand(4, 3, 2, 3, 3, scale=0.3))
    grads = []
    for use_s2d in (False, True):
        conv = Conv2d(2, 3, 3, padding=1, bias=False)
        with torch.no_grad():
            conv.weight.copy_(w)
        y = conv.s2d(s2d.space_to_depth(x)) if use_s2d else conv(x)
        (y ** 2).mean().backward()
        grads.append(conv.weight.grad.numpy())
    assert np.abs(grads[0]).max() > 1e-3
    _close(grads[1], grads[0], 1e-6)


def test_expand_vector_and_s2d_batchnorm_stats_match_jax():
    """The batch statistics BatchNorm2d.s2d takes from an s2d tensor (read
    as the running statistics after one train step at momentum 1) against
    JAX's ``bn_stats``: mean, and torch's unbiased variance of the
    biased one over the B*H*W values of each original channel."""
    v = _rand(5, 6)
    np.testing.assert_array_equal(s2d.expand_vector(torch.from_numpy(v)),
                                  np.asarray(jax_s2d.expand_vector(v)))
    x = _rand(6, 3, 8, 6, 7, scale=2.0) + 1.0
    bn = BatchNorm2d(7, momentum=1.0).train()
    with torch.no_grad():
        bn.s2d(s2d.space_to_depth(to_port(x)))
    mean, var = jax_s2d.bn_stats(jax_s2d.space_to_depth(jnp.asarray(x)))
    n = x.size // 7
    _close(bn.running_mean.numpy(), mean)
    _close(bn.running_var.numpy(), np.asarray(var) * n / (n - 1))
    _close(bn.running_mean.numpy(), x.mean(axis=(0, 1, 2)))


@pytest.mark.parametrize("train", [True, False])
def test_phase_group_batchnorm_equals_the_plain_one(train):
    """BatchNorm2d.s2d on the s2d tensor: the output, the running
    statistics (torch's unbiased variance over B*H*W) and the batch count
    of the plain BatchNorm2d on the unpacked map."""
    x = to_port(_rand(7, 3, 8, 6, 5, scale=2.0) + 0.5)
    bns = [BatchNorm2d(5), BatchNorm2d(5)]
    for bn in bns:
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(0.5 + np.abs(_rand(8, 5))))
            bn.bias.copy_(torch.from_numpy(_rand(9, 5, scale=0.1)))
            bn.running_mean.fill_(0.3)
            bn.running_var.fill_(1.7)
        bn.train(train)
    with torch.no_grad():
        want = bns[0](x)
        got = s2d.depth_to_space(bns[1].s2d(s2d.space_to_depth(x)))
    _close(to_nhwc(got), to_nhwc(want))
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        a, b = getattr(bns[1], name), getattr(bns[0], name)
        _close(a.numpy(), b.numpy(), 1e-6)
    assert int(bns[1].num_batches_tracked) == int(train)
    if train:
        assert not torch.equal(bns[1].running_var, torch.full((5,), 1.7))
    with pytest.raises(ValueError, match="expected 20"):
        bns[1].s2d(torch.zeros(1, 8, 2, 2))


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("from_s2d", [False, True])
def test_upsample_bilinear_s2d_matches_jax(align, from_s2d):
    x = _rand(15, 2, 6, 8, 3)
    xj = jax_s2d.space_to_depth(jnp.asarray(x)) if from_s2d else x
    want = jax_s2d.upsample_bilinear_s2d(jnp.asarray(xj), align_corners=align,
                                         from_s2d=from_s2d)
    xp = s2d.space_to_depth(to_port(x)) if from_s2d else to_port(x)
    got = s2d.upsample_bilinear_s2d(xp, align_corners=align,
                                    from_s2d=from_s2d)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(to_nhwc(got), want)
    # and the s2d form of the plain upsample
    ref = jax_s2d.space_to_depth(jax_upsample(jnp.asarray(x), 2,
                                              align_corners=align))
    _close(to_nhwc(got), ref)


def test_upsample_bilinear_s2d_above_the_jax_matmul_limit_matches_jax():
    """A map side above the JAX version's matmul limit
    (``BILINEAR_MATMUL_MAX_IN``), where it takes its gather form."""
    from jcfszxc_unet_tpu.ops.layers import BILINEAR_MATMUL_MAX_IN

    x = _rand(16, 1, 292, 4, 2)
    assert x.shape[1] > BILINEAR_MATMUL_MAX_IN
    want = jax_s2d.upsample_bilinear_s2d(jnp.asarray(x))
    _close(to_nhwc(s2d.upsample_bilinear_s2d(to_port(x))), want)
    xs = jax_s2d.space_to_depth(jnp.asarray(x))
    want = jax_s2d.upsample_bilinear_s2d(xs, from_s2d=True)
    got = s2d.upsample_bilinear_s2d(s2d.space_to_depth(to_port(x)),
                                    from_s2d=True)
    _close(to_nhwc(got), want)


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 4, 10, 5)])
def test_maxpool_exit_matches_jax(shape):
    x = _rand(17, *shape)
    got = s2d.maxpool_exit(s2d.space_to_depth(to_port(x)))
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = jax_s2d.maxpool_exit(jax_s2d.space_to_depth(jnp.asarray(x)))
    np.testing.assert_array_equal(to_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 4, 10, 5)])
def test_avgpool_exit_matches_jax(shape):
    x = _rand(18, *shape)
    got = s2d.avgpool_exit(s2d.space_to_depth(to_port(x)))
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = jax_s2d.avgpool_exit(jax_s2d.space_to_depth(jnp.asarray(x)))
    _close(to_nhwc(got), want)


def test_cached_selector_made_in_inference_mode_serves_training():
    """The selector is cached per device and dtype; the first call may
    come from an evaluation under ``torch.inference_mode``, and a train
    step after it must still be able to save it for the backward."""
    s2d._selector_tensor.cache_clear()
    conv = Conv2d(3, 4, 3, padding=1, dilation=1)
    x = s2d.space_to_depth(to_port(_rand(40, 1, 8, 8, 3)))
    with torch.inference_mode():
        conv.s2d(x)
    xg = x.clone().requires_grad_(True)
    conv.s2d(xg).sum().backward()
    assert conv.weight.grad is not None and xg.grad is not None
