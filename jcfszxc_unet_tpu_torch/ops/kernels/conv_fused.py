"""Fused 3x3 conv + per-channel affine + ReLU.

``relu?(conv3x3_SAME(x, w) * scale + shift)`` on NHWC ``x (B, H, W, Cin)``
and HWIO ``w (3, 3, Cin, Cout)``, accumulated in f32 and stored once in
``x.dtype``.  In the eval-mode UNet forward every DoubleConv conv goes
through it with its BatchNorm folded into ``scale``/``shift``.

Kernel: ``csrc/conv3x3_affine_relu.cu``, CUDA C++ for sm_90a, replacing
the TPU kernel ``conv3x3_affine_relu_pallas`` in
``jcfszxc_unet_tpu/ops/pallas/conv_fused.py``.  It is an implicit GEMM
(M = B*H*W, N = Cout, K = 9*Cin) whose out-of-image taps are masked
rather than padded; bf16 runs on the tensor cores (``mma.sync``), f32 on
FMAs so that its products stay f32.  At UNet's shapes the work is bound
by operations, and this simple form stays well below the bf16
tensor-core peak; ``wgmma`` tiles fed by TMA are the next step.

:func:`conv3x3_affine_relu_torch` is the plain PyTorch version.  The
wrapper takes it only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jcfszxc_unet_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

counter = build.LaunchCounter()


def conv3x3_affine_relu_torch(x, w, scale, shift, relu: bool = True):
    """Plain version: ``F.conv2d`` on f32-upcast inputs, then the affine,
    the optional ReLU and one cast to ``x.dtype``.  Returns contiguous
    NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.permute(3, 2, 0, 1).float(), padding=1)
    y = y * scale.float().view(1, -1, 1, 1) + shift.float().view(1, -1, 1, 1)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def _validate(x, w, scale, shift):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(
            f"expected x (B,H,W,Cin) and w (3,3,Cin,Cout), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")
    cin, cout = w.shape[2], w.shape[3]
    if x.shape[3] != cin:
        raise ValueError(f"x has {x.shape[3]} channels, w expects {cin}")
    if tuple(scale.shape) != (cout,) or tuple(shift.shape) != (cout,):
        raise ValueError(f"scale and shift must have shape ({cout},)")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(
            f"x and w must share float32 or bfloat16, got {x.dtype} and "
            f"{w.dtype}")
    if scale.dtype != torch.float32 or shift.dtype != torch.float32:
        raise TypeError("scale and shift must be float32")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("shift", shift)):
        if not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous in the layout given (for x: a "
                f"channels_last NCHW tensor permuted to NHWC)")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def conv3x3_affine_relu(x, w, scale, shift, relu: bool = True):
    """``relu?(conv3x3_SAME(x, w) * scale + shift)`` in ``x.dtype``.

    x: (B, H, W, Cin) float32 or bfloat16, contiguous; w: (3, 3, Cin, Cout)
    of the same dtype, contiguous; scale, shift: (Cout,) float32.
    """
    _validate(x, w, scale, shift)
    if x.device.type == "cpu":
        return conv3x3_affine_relu_torch(x, w, scale, shift, relu)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    lib = build.load_library()
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec = int(cin % 8 == 0 and x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.conv3x3_affine_relu_launch(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
            b, h, wd, cin, cout, int(relu), vec, stream)
    build.check(lib, code, "conv3x3_affine_relu")
    counter.launches += 1
    return out
