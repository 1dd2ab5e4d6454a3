"""The im2col conv of the port's probe against the TPU probe's own parity
reference, ``conv3x3_affine_relu_xla(x, w, 1, 0)``
(scripts/tpu_imcol_conv_probe.py:115).

On the CPU the wrapper runs its plain version.  The kernel's addressing
(a pixel's base in the padded buffer plus a per-column offset, K walked
in runs of 8) is emulated on the operands the wrapper builds, so the
layout that only the card reads is checked here too.  The ``cuda`` test
holds the kernel against the plain version on a GPU and skips elsewhere.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.ops.pallas.conv_fused import conv3x3_affine_relu_xla
from jcfszxc_unet_tpu_torch.ops.kernels import conv_imcol, conv_plan
from jcfszxc_unet_tpu_torch.ops.kernels.conv_imcol import (
    conv3x3_relu_imcol,
    conv3x3_relu_imcol_torch,
    pad_inputs,
)

# (B, H, W, Cin, Cout): the probe's channel ratio at a small size, and a
# ragged image with Cin = 3 (channels padded to 8).
CASES = [(2, 16, 16, 8, 8), (1, 13, 11, 3, 8)]


def _inputs(b, h, w, cin, cout, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.rand(b, h, w, cin) - 0.5).astype(np.float32)
    wt = ((rng.rand(3, 3, cin, cout) - 0.5) * 0.1).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("b,h,w,cin,cout", CASES)
def test_plain_matches_the_probe_reference(b, h, w, cin, cout):
    x, wt = _inputs(b, h, w, cin, cout, seed=cin)
    got = conv3x3_relu_imcol_torch(torch.from_numpy(x), torch.from_numpy(wt))
    one, zero = jnp.ones((cout,)), jnp.zeros((cout,))
    want = np.asarray(conv3x3_affine_relu_xla(jnp.asarray(x), jnp.asarray(wt),
                                              one, zero))
    assert got.shape == (b, h, w, cout) and got.is_contiguous()
    # f32 on both sides; the sums differ only in order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got == 0).any() and (got > 0).any()  # the ReLU cuts


def _emulate_kernel(xp, wt, h, w):
    """The kernel's arithmetic in numpy, on its operands: output pixel p
    reads xp at pixel_base(p) + k_offset(k) for k in [0, 9*C), against
    row n of wt; ReLU."""
    xp = xp.numpy().reshape(-1)
    wt = wt.numpy()
    cout, k_total = wt.shape
    c = k_total // 9
    b = xp.size // ((h + 2) * (w + 2) * c)
    out = np.zeros((b * h * w, cout), np.float64)
    ks = np.arange(k_total)
    tap, ch = ks // c, ks % c
    k_off = ((tap // 3) * (w + 2) + tap % 3) * c + ch
    for p in range(b * h * w):
        row, x = divmod(p, w)
        bb, y = divmod(row, h)
        base = ((bb * (h + 2) + y) * (w + 2) + x) * c
        out[p] = wt @ xp[base + k_off]
    return np.maximum(out, 0.0).reshape(b, h, w, cout)


@pytest.mark.parametrize("b,h,w,cin,cout", CASES + [(2, 5, 7, 16, 3)])
def test_kernel_addressing_on_the_padded_operands(b, h, w, cin, cout):
    x, wt = map(torch.from_numpy, _inputs(b, h, w, cin, cout, seed=1))
    xp, w2 = pad_inputs(x, wt)
    c8 = -(-cin // 8) * 8
    assert xp.shape == (b, h + 2, w + 2, c8) and xp.is_contiguous()
    assert w2.shape == (cout, 9 * c8) and w2.is_contiguous()
    assert float(xp[:, 0].abs().sum() + xp[:, -1].abs().sum()
                 + xp[..., cin:].abs().sum()) == 0.0  # zero border, channels
    want = conv3x3_relu_imcol_torch(x, wt).numpy()
    np.testing.assert_allclose(_emulate_kernel(xp, w2, h, w), want,
                               rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    x, wt = map(torch.from_numpy, _inputs(1, 13, 11, 3, 8))
    before = conv_imcol.counter.launches
    assert torch.equal(conv3x3_relu_imcol(x, wt),
                       conv3x3_relu_imcol_torch(x, wt))
    assert conv_imcol.counter.launches == before
    bf = conv3x3_relu_imcol(x.bfloat16(), wt.bfloat16())
    assert bf.dtype == torch.bfloat16


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, wt = map(torch.from_numpy, _inputs(1, 6, 6, 8, 4))
    with pytest.raises(TypeError):
        conv3x3_relu_imcol(x.double(), wt.double())
    with pytest.raises(TypeError):
        conv3x3_relu_imcol(x, wt.bfloat16())
    with pytest.raises(ValueError, match="channels"):
        conv3x3_relu_imcol(x[..., :4], wt)
    with pytest.raises(ValueError):
        conv3x3_relu_imcol(x, wt[:2])
    # no silent fall-back to the plain version off the CPU
    with pytest.raises(ValueError, match="no kernel for device"):
        conv3x3_relu_imcol(x.to("meta"), wt.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        conv_imcol.conv3x3_relu_imcol_padded(*pad_inputs(x, wt))


def test_probe_module_runs_nothing_on_import_and_needs_a_gpu():
    probe = importlib.import_module(
        "jcfszxc_unet_tpu_torch.scripts.imcol_conv_probe")
    assert (probe.B, probe.H, probe.W, probe.CIN, probe.COUT) == (
        64, 128, 128, 128, 64)  # the TPU probe's defaults
    with pytest.raises(RuntimeError, match="needs a GPU"):
        probe.run_probe(b=1, h=8, w=8, cin=8, cout=8, device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,h,w,cin,cout",
                         CASES + [(2, 37, 29, 64, 64), (2, 32, 32, 128, 64),
                                  (4, 8, 8, 64, 64), (2, 37, 29, 72, 96),
                                  (1, 8, 16, 64, 64)])
def test_kernel_matches_plain_on_gpu(cuda_device, dtype, tol, b, h, w, cin,
                                     cout):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(cin + h)
    x = torch.from_numpy(rng.randn(b, h, w, cin).astype(np.float32))
    wt = torch.from_numpy((rng.randn(3, 3, cin, cout)
                           / math.sqrt(9 * cin)).astype(np.float32))
    x, wt = x.to(cuda_device, dtype), wt.to(cuda_device, dtype)
    before = conv_imcol.counter.launches
    body = "wgmma" if dtype == torch.bfloat16 else "fma"
    runs = conv_imcol.counter.bodies.get(body, 0)
    got = conv3x3_relu_imcol(x, wt).float()
    want = conv3x3_relu_imcol_torch(x, wt).float()
    torch.cuda.synchronize()
    assert conv_imcol.counter.launches == before + 1
    assert conv_imcol.counter.bodies[body] == runs + 1
    # both accumulate in f32: summation order and (bf16) one rounding
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launcher_refuses_a_plan_that_does_not_cover_the_output(cuda_device,
                                                                dtype):
    x, wt = (torch.from_numpy(a).to(cuda_device, dtype)
             for a in _inputs(2, 16, 130, 64, 136))
    xp, w2 = pad_inputs(x, wt)
    before = conv_imcol.counter.launches
    for shape in ((1, 16, 130, 136), (2, 8, 130, 136), (2, 16, 65, 136),
                  (2, 16, 130, 64)):
        plan = conv_plan.plan_conv(*shape[:3], 64, shape[3], dtype, True,
                                   conv_plan.sm_count(cuda_device),
                                   imcol=True)
        with pytest.raises(RuntimeError, match="CUDA error"):
            conv_imcol.launch(xp, w2, plan)
    assert conv_imcol.counter.launches == before
