"""3x3 SAME conv + ReLU as one deep im2col product.

``relu(conv3x3_SAME(x, w))`` on NHWC ``x (B, H, W, Cin)`` and HWIO
``w (3, 3, Cin, Cout)``, accumulated in f32 and stored once in
``x.dtype``; no affine.  Its entry point is the timing probe
``jcfszxc_unet_tpu_torch.scripts.imcol_conv_probe``.

Kernel: ``csrc/conv3x3_relu_imcol.cu``, CUDA C++ for sm_90a, replacing the
TPU kernel ``make_imcol_kernel.run`` in ``scripts/tpu_imcol_conv_probe.py``.
The probe's design is kept: the wrapper writes a zero-padded copy of x
(:func:`pad_inputs`, the probe's ``jnp.pad``), so the kernel reads the
halo with no bounds test and runs one K = 9*Cin reduction per output tile
against the weights viewed as one (9*Cin, Cout) matrix.  The copy also
pads the channels to a multiple of 8, and the weights go over transposed,
(Cout, 9*Cin8), so that both operands are K-major.  The kernel is bound by
operations at the probe's geometry, so bf16 runs on the tensor cores'
``wgmma`` path, which its first ``mma.sync`` form (140 TFLOP/s) did not
reach: the TMA-fed mainloop of ``csrc/conv3x3_wgmma.cuh`` that kernel 1
uses, with a 4-D tensor map over the padded copy (halo 0) and the weights
viewed as (Cout, 9, Cin8).  Cin8 is a multiple of 8, so every bf16 call
takes it.  f32 runs on FMAs so that its products stay f32.  The padded
copy adds bytes outside the kernel.

:func:`conv3x3_relu_imcol_torch` is the plain PyTorch version, the same
arithmetic as the probe's kernel.  The wrapper checks its inputs, pads
them and calls the ``jcfszxc_unet::conv3x3_relu_imcol`` operator
(``library.py``) on the padded operands, which takes the plain version
only for tensors on the CPU; for a CUDA tensor it launches the kernel
(:func:`launch`) or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jcfszxc_unet_tpu_torch.ops.kernels import build, conv_plan

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

counter = build.LaunchCounter()


def conv3x3_relu_imcol_torch(x, w):
    """Plain version: pad x by one pixel, lay the nine shifted views side
    by side as a (B*H*W, 9*Cin) matrix, one f32 product with w viewed as
    (9*Cin, Cout), ReLU, one cast to ``x.dtype``.  Returns contiguous
    NHWC."""
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + wd, :]
                      for dy in range(3) for dx in range(3)], dim=-1)
    y = cols.reshape(-1, 9 * cin) @ w.float().reshape(9 * cin, cout)
    return torch.relu(y).to(x.dtype).reshape(b, h, wd, cout)


def _validate(x, w):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(
            f"expected x (B,H,W,Cin) and w (3,3,Cin,Cout), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[3] != w.shape[2]:
        raise ValueError(f"x has {x.shape[3]} channels, w expects "
                         f"{w.shape[2]}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(
            f"x and w must share float32 or bfloat16, got {x.dtype} and "
            f"{w.dtype}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")


def pad_inputs(x, w):
    """The kernel's operands: ``xp`` (B, H+2, W+2, Cin8), x with a zero
    border of one pixel and zero channels up to Cin8 = ceil(Cin / 8) * 8;
    ``wt`` (Cout, 9*Cin8), row n = w[..., n] raveled (dy, dx, c) with the
    padded channels zero.  Both contiguous."""
    _validate(x, w)
    b, h, wd, cin = x.shape
    c8 = -(-cin // 8) * 8
    # Zero only the border and the extra channels, then copy x in once:
    # fewer bytes than a pad that writes every element from a select.
    xp = x.new_empty((b, h + 2, wd + 2, c8))
    for border in (xp[:, 0], xp[:, -1], xp[:, 1:-1, 0], xp[:, 1:-1, -1],
                   xp[..., cin:]):
        border.zero_()
    xp[:, 1:-1, 1:-1, :cin].copy_(x)
    wt = F.pad(w, (0, 0, 0, c8 - cin)).reshape(9 * c8, -1).t().contiguous()
    return xp, wt


def conv3x3_relu_imcol_padded(xp, wt):
    """The kernel alone on operands made by :func:`pad_inputs` (CUDA
    tensors; the operator's CUDA implementation also checks their 16-byte
    alignment).  Returns (B, H, W, Cout) in ``xp.dtype``."""
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    if xp.dim() != 4 or wt.dim() != 2 or xp.shape[3] % 8:
        raise ValueError(
            f"expected xp (B,H+2,W+2,C) with C % 8 == 0 and wt (Cout, 9*C), "
            f"got {tuple(xp.shape)} and {tuple(wt.shape)}")
    c8 = xp.shape[3]
    if wt.shape[1] != 9 * c8:
        raise ValueError(f"wt has {wt.shape[1]} columns, expected {9 * c8}")
    if xp.dtype not in _DTYPE_CODES or wt.dtype != xp.dtype:
        raise TypeError(f"xp and wt must share float32 or bfloat16, got "
                        f"{xp.dtype} and {wt.dtype}")
    for name, t in (("xp", xp), ("wt", wt)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")
    return torch.ops.jcfszxc_unet.conv3x3_relu_imcol.default(xp, wt)


def launch(xp, wt, plan: conv_plan.ConvPlan):
    """The kernel on checked CUDA operands with the given plan; raises on
    any error the launch function returns."""
    b, hp, wp, c8 = xp.shape
    cout = wt.shape[0]
    out = torch.empty((b, hp - 2, wp - 2, cout), dtype=xp.dtype,
                      device=xp.device)
    if out.numel() == 0:
        return out
    lib = build.load_library()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.conv3x3_relu_imcol_launch(
            _DTYPE_CODES[xp.dtype], xp.data_ptr(), wt.data_ptr(),
            out.data_ptr(), b, hp - 2, wp - 2, c8, cout, plan.ints(), stream)
    build.check(lib, code, "conv3x3_relu_imcol")
    counter.add(plan.body, conv_plan.schedule(plan))
    return out


def conv3x3_relu_imcol(x, w):
    """``relu(conv3x3_SAME(x, w))`` in ``x.dtype``.

    x: (B, H, W, Cin) float32 or bfloat16; w: (3, 3, Cin, Cout) of the
    same dtype.  Any B, H, W and Cin.
    """
    _validate(x, w)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return torch.ops.jcfszxc_unet.conv3x3_relu_imcol.default(
        *pad_inputs(x, w))
