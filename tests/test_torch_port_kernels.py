"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the JAX function of the same name, against the
Pallas kernel in interpret mode (as tests/test_pallas.py runs it) and,
for Dice, against ``losses.dice_coeff``.  Inputs come from numpy with a
fixed seed; everything is f32.  The ``cuda`` tests hold the CUDA kernels
against the plain versions on a GPU and skip elsewhere.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.ops.pallas.conv_fused import (
    conv3x3_affine_relu_pallas,
    conv3x3_affine_relu_xla,
)
from jcfszxc_unet_tpu.ops.pallas.dice_fused import (
    dice_coeff_hard as jax_dice_coeff_hard,
    dice_sums_pallas,
    dice_sums_xla,
)
from jcfszxc_unet_tpu.train.losses import dice_coeff
from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, dice_fused
from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
    conv3x3_affine_relu,
    conv3x3_affine_relu_torch,
)
from jcfszxc_unet_tpu_torch.ops.kernels.dice_fused import (
    dice_coeff_hard,
    dice_sums,
    dice_sums_torch,
)

# (B, H, W, Cin, Cout, relu): UNet's inc (Cin 3 -> 64), a 16 -> 128 conv,
# ReLU off, and a ragged 7 x 10 image.
CONV_CASES = [
    (2, 8, 8, 3, 64, True),
    (1, 8, 6, 16, 128, True),
    (2, 6, 8, 16, 128, False),
    (2, 7, 10, 3, 64, False),
]


def _conv_inputs(b, h, w, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) / math.sqrt(9 * cin)).astype(np.float32)
    scale = (0.5 + rng.rand(cout)).astype(np.float32)
    shift = (0.1 * rng.randn(cout)).astype(np.float32)
    return x, wt, scale, shift


@pytest.mark.parametrize("b,h,w,cin,cout,relu", CONV_CASES)
def test_conv_plain_matches_jax(b, h, w, cin, cout, relu):
    x, wt, scale, shift = _conv_inputs(b, h, w, cin, cout, seed=cin + h)
    got = conv3x3_affine_relu_torch(*map(torch.from_numpy,
                                         (x, wt, scale, shift)), relu=relu)
    xla = conv3x3_affine_relu_xla(*map(jnp.asarray, (x, wt, scale, shift)),
                                  relu=relu)
    pallas = conv3x3_affine_relu_pallas(
        *map(jnp.asarray, (x, wt, scale, shift)), relu=relu, interpret=True)
    assert got.shape == (b, h, w, cout) and got.is_contiguous()
    # f32 on both sides; the sums differ only in order
    np.testing.assert_allclose(got.numpy(), np.asarray(xla),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=1e-5, atol=1e-5)
    if not relu:
        assert got.min() < 0


def test_conv_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    x, wt, scale, shift = map(torch.from_numpy,
                              _conv_inputs(2, 7, 10, 3, 64, seed=0))
    before = conv_fused.counter.launches
    got = conv3x3_affine_relu(x, wt, scale, shift)
    want = conv3x3_affine_relu_torch(x, wt, scale, shift)
    assert torch.equal(got, want)
    assert conv_fused.counter.launches == before  # counts kernel launches only


def test_conv_wrapper_rejects_what_the_kernel_does_not_take():
    x, wt, scale, shift = map(torch.from_numpy,
                              _conv_inputs(1, 6, 6, 8, 16, seed=1))
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_affine_relu(x.transpose(1, 2), wt, scale, shift)
    with pytest.raises(TypeError):
        conv3x3_affine_relu(x.double(), wt.double(), scale, shift)
    with pytest.raises(TypeError):
        conv3x3_affine_relu(x, wt, scale.bfloat16(), shift)
    with pytest.raises(ValueError, match="channels"):
        conv3x3_affine_relu(x[..., :4].contiguous(), wt, scale, shift)
    # no silent fall-back to the plain version off the CPU
    with pytest.raises(ValueError, match="no kernel for device"):
        conv3x3_affine_relu(*(t.to("meta") for t in (x, wt, scale, shift)))


def _dice_inputs(seed=3):
    rng = np.random.RandomState(seed)
    p = (rng.rand(4, 13, 11) * 1.4 - 0.2).astype(np.float32)  # beyond [0, 1]
    t = (rng.rand(4, 13, 11) > 0.6).astype(np.float32)
    p[2] = -0.5   # empty-mask sample: clamped p and t both sum to 0
    t[2] = 0.0
    return p, t


def test_dice_sums_plain_matches_jax():
    p, t = _dice_inputs()
    got = dice_sums_torch(torch.from_numpy(p), torch.from_numpy(t))
    for ref in (dice_sums_xla(jnp.asarray(p), jnp.asarray(t)),
                dice_sums_pallas(jnp.asarray(p), jnp.asarray(t),
                                 interpret=True)):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


def test_dice_coeff_hard_matches_jax_and_reference_formula():
    p, t = _dice_inputs()
    got = float(dice_coeff_hard(torch.from_numpy(p), torch.from_numpy(t)))
    want = float(dice_coeff(jnp.asarray(p), jnp.asarray(t),
                            reduce_batch_first=False))
    pallas = float(jax_dice_coeff_hard(jnp.asarray(p), jnp.asarray(t),
                                       use_pallas=True, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-6)


def test_dice_wrapper_on_cpu_and_its_checks():
    p, t = map(torch.from_numpy, _dice_inputs())
    before = dice_fused.counter.launches
    for g, w in zip(dice_sums(p, t), dice_sums_torch(p, t)):
        assert torch.equal(g, w)
    assert dice_fused.counter.launches == before
    with pytest.raises(TypeError):
        dice_sums(p.double(), t.double())
    with pytest.raises(ValueError):
        dice_sums(p, t[:, :5])
    with pytest.raises(ValueError, match="contiguous"):
        dice_sums(p.transpose(1, 2), t.transpose(1, 2))
    with pytest.raises(ValueError, match="no kernel for device"):
        dice_sums(p.to("meta"), t.to("meta"))


# ---------------------------------------------------------------------------
# On the card: kernels against their plain versions (python3 -m pytest -m cuda)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,h,w,cin,cout,relu", CONV_CASES)
def test_conv_kernel_matches_plain_on_gpu(cuda_device, dtype, tol, b, h, w,
                                          cin, cout, relu):
    torch.backends.cudnn.allow_tf32 = False
    x, wt, scale, shift = (torch.from_numpy(a).to(cuda_device) for a in
                           _conv_inputs(b, h, w, cin, cout, seed=cin + h))
    x, wt = x.to(dtype), wt.to(dtype)
    before = conv_fused.counter.launches
    got = conv3x3_affine_relu(x, wt, scale, shift, relu=relu).float()
    want = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=relu).float()
    torch.cuda.synchronize()
    assert conv_fused.counter.launches == before + 1
    # both accumulate in f32: summation order and (bf16) one rounding
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
def test_dice_kernel_matches_plain_on_gpu(cuda_device):
    p, t = (torch.from_numpy(a).to(cuda_device) for a in _dice_inputs())
    before = dice_fused.counter.launches
    got = dice_sums(p, t)
    want = dice_sums_torch(p, t)
    assert dice_fused.counter.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
