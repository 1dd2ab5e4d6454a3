"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the JAX function of the same name, against the
Pallas kernel in interpret mode (as tests/test_pallas.py runs it) and,
for Dice, against ``losses.dice_coeff``.  Inputs come from numpy with a
fixed seed; everything is f32.  The ``cuda`` tests hold the CUDA kernels
against the plain versions on a GPU and skip elsewhere.
"""

import dataclasses
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
from jcfszxc_unet_tpu_torch.ops.kernels import (
    conv_fused,
    conv_plan,
    dice_fused,
)
from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
    conv3x3_affine_relu,
    conv3x3_affine_relu_kmajor,
    conv3x3_affine_relu_torch,
)
from jcfszxc_unet_tpu_torch.ops.kernels.dice_fused import (
    dice_coeff_hard,
    dice_sums,
    dice_sums_torch,
)

from .test_torch_port_conv_box import CASES as CONV_BOX_CASES

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


def test_conv_kmajor_entry_on_cpu_is_the_plain_version():
    x, wt, scale, shift = map(torch.from_numpy,
                              _conv_inputs(2, 7, 10, 16, 24, seed=2))
    w_km = wt.permute(3, 0, 1, 2).contiguous()  # (Cout, 3, 3, Cin)
    before = conv_fused.counter.launches
    got = conv3x3_affine_relu_kmajor(x, w_km, scale, shift, relu=False)
    want = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=False)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert conv_fused.counter.launches == before
    with pytest.raises(ValueError, match="channels"):
        conv3x3_affine_relu_kmajor(x, wt.permute(3, 0, 1, 2)[..., :8]
                                   .contiguous(), scale, shift)
    with pytest.raises(ValueError, match="no kernel for device"):
        conv3x3_affine_relu_kmajor(*(t.to("meta")
                                     for t in (x, w_km, scale, shift)))


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


# Edges of the wgmma body's plan: one tile, boxes spanning images, ragged
# W and H, Cin not a multiple of 64, Cout not a multiple of BN, ReLU off.
PLAN_EDGE_CASES = [
    (1, 8, 16, 64, 64, True),
    (4, 8, 8, 64, 64, True),
    (64, 8, 8, 128, 128, True),
    (2, 37, 29, 64, 64, True),
    (2, 37, 29, 16, 64, True),
    (2, 37, 29, 72, 96, False),
    (2, 16, 16, 64, 96, True),
    (2, 8, 8, 64, 160, False),
    (2, 8, 8, 256, 320, True),
]


# Shapes the zoo's eval forwards give the kernel beyond UNet's: Cout 32
# (NestedUNet's row 0) and 1 (SegNet's head) under one 64-wide tile, Cin
# 96/160/192/320/384/768 (NestedUNet's dense nodes, ResUNet's and
# AttentionUNet's concats), ReLU off (bias as the shift), Cin 3 with ReLU
# off (ResUNet's input_skip), whole-image maps: UNet's first and last
# level at 608 x 576 and SegNet's 19 x 18; MultiResUNet's truncated widths
# (odd Cin and Cout on mma_sync, Cin 8 and odd Cout on wgmma), BCDU-Net's
# Cout-2 head with ReLU and a ConvLSTM gate conv at twice the batch;
# TransFuseNet's Cin 24 and 48 to Cout 16 and 32, 8 -> 8 and 8 -> 16, and
# BARUNet's second BABasicBlock conv (ReLU off).
ZOO_CASES = [
    (2, 32, 32, 64, 32, True),
    (2, 32, 32, 96, 32, True),
    (2, 32, 32, 64, 1, False),
    (2, 16, 16, 160, 64, True),
    (2, 16, 16, 192, 64, False),
    (2, 8, 8, 320, 128, True),
    (2, 8, 8, 384, 128, False),
    (2, 8, 8, 768, 256, False),
    (2, 16, 16, 3, 64, False),
    (1, 608, 576, 3, 64, True),
    (1, 608, 576, 64, 64, True),
    (1, 38, 36, 1024, 512, True),
    (1, 19, 18, 512, 512, True),
    (2, 32, 32, 3, 8, True),
    (2, 32, 32, 8, 17, True),
    (2, 32, 32, 17, 26, True),
    (2, 16, 16, 35, 53, True),
    (2, 8, 8, 142, 213, True),
    (2, 4, 4, 284, 427, True),
    (2, 16, 16, 128, 17, True),
    (2, 32, 32, 64, 2, True),
    (4, 16, 16, 256, 512, False),
    (2, 32, 32, 24, 16, True),
    (2, 32, 32, 48, 32, True),
    (2, 64, 64, 8, 8, True),
    (2, 32, 32, 8, 16, True),
    (2, 16, 16, 128, 128, False),
]


def _check_conv_on_gpu(device, dtype, tol, b, h, w, cin, cout, relu):
    torch.backends.cudnn.allow_tf32 = False
    x, wt, scale, shift = (torch.from_numpy(a).to(device) for a in
                           _conv_inputs(b, h, w, cin, cout, seed=cin + h))
    x, wt = x.to(dtype), wt.to(dtype)
    before = conv_fused.counter.launches
    bodies = dict(conv_fused.counter.bodies)
    got = conv3x3_affine_relu(x, wt, scale, shift, relu=relu).float()
    want = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=relu).float()
    torch.cuda.synchronize()
    assert conv_fused.counter.launches == before + 1
    # the body that ran: for a bf16 call with Cin % 8 == 0 the narrow body
    # where Cin <= 32 or Cout <= 32 (conv_plan.takes_narrow), else wgmma
    body = {torch.float32: "f32_box",
            torch.bfloat16: "mma_sync" if cin % 8
            else "narrow" if conv_plan.takes_narrow(cin, cout)
            else "wgmma"}[dtype]
    assert conv_fused.counter.bodies.get(body, 0) == bodies.get(body, 0) + 1
    # both accumulate in f32: summation order and (bf16) one rounding
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,h,w,cin,cout,relu", CONV_CASES)
def test_conv_kernel_matches_plain_on_gpu(cuda_device, dtype, tol, b, h, w,
                                          cin, cout, relu):
    _check_conv_on_gpu(cuda_device, dtype, tol, b, h, w, cin, cout, relu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,h,w,cin,cout,relu", PLAN_EDGE_CASES)
def test_conv_kernel_plan_edges_on_gpu(cuda_device, dtype, tol, b, h, w, cin,
                                       cout, relu):
    _check_conv_on_gpu(cuda_device, dtype, tol, b, h, w, cin, cout, relu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,h,w,cin,cout,relu", ZOO_CASES)
def test_conv_kernel_zoo_shapes_on_gpu(cuda_device, dtype, tol, b, h, w, cin,
                                       cout, relu):
    _check_conv_on_gpu(cuda_device, dtype, tol, b, h, w, cin, cout, relu)


# The mma_sync body (bf16, Cin % 8 != 0) at the shapes its CPU emulation
# covers (tests/test_torch_port_conv_box.py), beside the plain version.
BOX_CASES = [case[:6] for case in CONV_BOX_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout,relu", BOX_CASES)
def test_conv_box_body_matches_plain_on_gpu(cuda_device, b, h, w, cin, cout,
                                            relu):
    _check_conv_on_gpu(cuda_device, torch.bfloat16, 1e-2, b, h, w, cin, cout,
                       relu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cin", [(torch.bfloat16, 64),
                                       (torch.bfloat16, 3),
                                       (torch.float32, 64)])
def test_conv_wrapper_raises_when_the_launch_is_refused(cuda_device, dtype,
                                                        cin):
    x, wt, scale, shift = (torch.from_numpy(a).to(cuda_device) for a in
                           _conv_inputs(1, 8, 16, cin, 64, seed=5))
    x, wt = x.to(dtype), wt.to(dtype)
    w_km = wt.permute(3, 0, 1, 2).contiguous()
    plan = conv_fused.plan_for(x, w_km)
    before = conv_fused.counter.launches
    # an empty grid: refused
    with pytest.raises(RuntimeError, match="CUDA error"):
        conv_fused.launch(x, w_km, scale, shift, True,
                          dataclasses.replace(plan, grid=(0, 1)))
    # a body the dtype and shape do not take: refused by the launcher
    other = "wgmma" if plan.body != "wgmma" else "fma"
    with pytest.raises(RuntimeError, match="CUDA error"):
        conv_fused.launch(x, w_km, scale, shift, True,
                          dataclasses.replace(plan, body=other))
    torch.cuda.synchronize()
    assert conv_fused.counter.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cin", [(torch.bfloat16, 64),
                                       (torch.bfloat16, 3),
                                       (torch.float32, 64)])
@pytest.mark.parametrize("smaller", ["batch", "height", "width", "cout"])
def test_conv_launcher_refuses_a_plan_that_does_not_cover_the_output(
        cuda_device, dtype, cin, smaller):
    b, h, w, cout = 2, 16, 130, 136
    x, wt, scale, shift = (torch.from_numpy(a).to(cuda_device) for a in
                           _conv_inputs(b, h, w, cin, cout, seed=6))
    x, wt = x.to(dtype), wt.to(dtype)
    w_km = wt.permute(3, 0, 1, 2).contiguous()
    shape = {"batch": (1, h, w, cout), "height": (b, h // 2, w, cout),
             "width": (b, h, w // 2, cout), "cout": (b, h, w, 64)}[smaller]
    plan = conv_plan.plan_conv(*shape[:3], cin, shape[3], dtype, True,
                               conv_plan.sm_count(cuda_device))
    assert plan.body == conv_fused.plan_for(x, w_km).body
    before = conv_fused.counter.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        conv_fused.launch(x, w_km, scale, shift, True, plan)
    assert conv_fused.counter.launches == before


@pytest.mark.cuda
def test_dice_kernel_matches_plain_on_gpu(cuda_device):
    p, t = (torch.from_numpy(a).to(cuda_device) for a in _dice_inputs())
    before = dice_fused.counter.launches
    got = dice_sums(p, t)
    want = dice_sums_torch(p, t)
    assert dice_fused.counter.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
